"""Tokenizers + token<->id conversion: this package's own copy of
espnet_slurp_tpu/data/tokenizer.py (char, word, BPE with its trainer,
phoneme, TokenIDConverter, build_token_list).

BPE is backed by HuggingFace `tokenizers`, imported only when a BPE
tokenizer is built; char/word are native. A token list file has one token
per line, line number = id, <blank> at 0 and <sos/eos> last (asr.sh
stage 5).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence


class AbsTokenizer:
    def text2tokens(self, line: str) -> List[str]:
        raise NotImplementedError

    def tokens2text(self, tokens: Iterable[str]) -> str:
        raise NotImplementedError


class CharTokenizer(AbsTokenizer):
    """Character tokenizer with <space> symbol (espnet2/text/char_tokenizer.py)."""

    def __init__(self, space_symbol: str = "<space>",
                 non_linguistic_symbols: Sequence[str] = ()):
        self.space_symbol = space_symbol
        self.nls = sorted(non_linguistic_symbols, key=len, reverse=True)

    def text2tokens(self, line: str) -> List[str]:
        tokens = []
        while line:
            for s in self.nls:
                if line.startswith(s):
                    tokens.append(s)
                    line = line[len(s):]
                    break
            else:
                c = line[0]
                tokens.append(self.space_symbol if c == " " else c)
                line = line[1:]
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class WordTokenizer(AbsTokenizer):
    def __init__(self, delimiter: str | None = None):
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


class BpeTokenizer(AbsTokenizer):
    """BPE via HuggingFace tokenizers, sentencepiece-style ▁ word boundary.

    marker="prefix" (default): HF Metaspace convention — word-INITIAL
    pieces start with ▁ ("▁ca", "t").
    marker="suffix": word-FINAL pieces end with ▁ ("ca", "t▁") — the
    reference fork's TCPGen dictionary convention
    (egs/slurp/asr1/conf: bpe_dict_unigram600suffix.txt). Suffix marking
    makes "a word just ended" observable from the PAST token stream, which
    is what lets the TCPGen trie walk reset to root (pointer live) at word
    starts and park at DEAD (pointer masked) mid-unknown-word with
    IDENTICAL semantics in teacher forcing and beam search
    (decoders.py:259,300-311). The underlying BPE model is trained once in
    Metaspace form; the marker only re-marks the emitted pieces.
    """

    def __init__(self, model_path: str, marker: str = "prefix"):
        from tokenizers import Tokenizer
        self.tok = Tokenizer.from_file(str(model_path))
        if marker not in ("prefix", "suffix"):
            raise ValueError(f"unknown BPE marker {marker!r}")
        self.marker = marker

    @staticmethod
    def _to_suffix(tokens: List[str]) -> List[str]:
        out: List[str] = []
        for t in tokens:
            start = t.startswith("▁")
            core = t[1:] if start else t
            if start and out:
                out[-1] += "▁"
            if core:
                out.append(core)
        if out:
            out[-1] += "▁"
        return out

    def text2tokens(self, line: str) -> List[str]:
        toks = self.tok.encode(line).tokens
        return self._to_suffix(toks) if self.marker == "suffix" else toks

    def tokens2text(self, tokens: Iterable[str]) -> str:
        # both conventions detokenize identically: ▁ -> space
        return "".join(tokens).replace("▁", " ").strip()

    @staticmethod
    def train(texts: Iterable[str], vocab_size: int, out_path: str,
              character_coverage: float = 1.0,
              marker: str = "prefix") -> "BpeTokenizer":
        """Train a BPE model over an iterator of raw text lines."""
        from tokenizers import Tokenizer, models, pre_tokenizers, trainers
        tok = Tokenizer(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
        trainer = trainers.BpeTrainer(vocab_size=vocab_size,
                                      special_tokens=[], show_progress=False)
        tok.train_from_iterator(texts, trainer)
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        tok.save(str(out_path))
        return BpeTokenizer(out_path, marker=marker)


class PhonemeTokenizer(AbsTokenizer):
    """Grapheme-to-phoneme tokenizer (espnet2/text/phoneme_tokenizer.py).

    The reference wraps external g2p libraries (g2p_en, pyopenjtalk, ...).
    Here the primary backend is a pronunciation lexicon file ('word PH ONE
    MES' per line, kaldi lexicon.txt convention) with per-letter fallback
    for OOV words; if the optional ``g2p_en`` package is installed it is
    used for OOVs instead of the letter fallback.
    """

    def __init__(self, lexicon: str | None = None,
                 word_separator: str | None = None):
        self.lex = {}
        if lexicon:
            with open(lexicon, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[0] not in self.lex:
                        self.lex[parts[0]] = parts[1:]
        self.word_separator = word_separator
        try:  # optional external g2p (not in the base image)
            from g2p_en import G2p  # type: ignore
            self._g2p = G2p()
        except Exception:
            self._g2p = None

    def _word(self, w: str) -> List[str]:
        if w in self.lex:
            return list(self.lex[w])
        if w.lower() in self.lex:
            return list(self.lex[w.lower()])
        if self._g2p is not None:
            return [p for p in self._g2p(w) if p.strip()]
        return list(w)  # letter fallback

    def text2tokens(self, line: str) -> List[str]:
        out: List[str] = []
        for i, w in enumerate(line.split()):
            if i > 0 and self.word_separator is not None:
                out.append(self.word_separator)
            out.extend(self._word(w))
        return out

    def tokens2text(self, tokens: Iterable[str]) -> str:
        # phones are not invertible; mirror the reference (join w/ spaces)
        return " ".join(tokens)


def build_tokenizer(token_type: str, bpemodel: str | None = None,
                    non_linguistic_symbols: Sequence[str] = (),
                    delimiter: str | None = None,
                    g2p_lexicon: str | None = None,
                    bpe_marker: str = "prefix") -> AbsTokenizer:
    """espnet2/text/build_tokenizer.py analogue."""
    if token_type == "char":
        return CharTokenizer(non_linguistic_symbols=non_linguistic_symbols)
    if token_type == "word":
        return WordTokenizer(delimiter=delimiter)
    if token_type == "bpe":
        if bpemodel is None:
            raise ValueError("token_type='bpe' needs bpemodel")
        return BpeTokenizer(bpemodel, marker=bpe_marker)
    if token_type == "phn":
        return PhonemeTokenizer(lexicon=g2p_lexicon)
    raise ValueError(f"unknown token_type {token_type}")


class TokenIDConverter:
    """token list (file or list) <-> ids (espnet2/text/token_id_converter.py)."""

    def __init__(self, token_list: str | Path | Sequence[str],
                 unk_symbol: str = "<unk>"):
        if isinstance(token_list, (str, Path)):
            with open(token_list, encoding="utf-8") as f:
                token_list = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.token_list: List[str] = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        if len(self.token2id) != len(self.token_list):
            raise ValueError("duplicated tokens in token list")
        self.unk_symbol = unk_symbol

    @property
    def vocab_size(self) -> int:
        return len(self.token_list)

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.token2id.get(self.unk_symbol)
        out = []
        for t in tokens:
            i = self.token2id.get(t, unk)
            if i is None:
                raise KeyError(f"token {t!r} not in vocab and no <unk>")
            out.append(i)
        return out

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.token_list[int(i)] for i in ids]


def build_token_list(texts: Iterable[str], tokenizer: AbsTokenizer,
                     blank: str = "<blank>", unk: str = "<unk>",
                     sos_eos: str = "<sos/eos>",
                     extra_symbols: Sequence[str] = ()) -> List[str]:
    """Collect vocabulary: <blank>, <unk>, [extra], tokens..., <sos/eos>.

    Matches asr.sh stage-5 token list layout (blank first, sos/eos last).
    """
    seen = {}
    for line in texts:
        for t in tokenizer.text2tokens(line):
            seen[t] = seen.get(t, 0) + 1
    toks = sorted(seen)
    return [blank, unk, *extra_symbols, *toks, sos_eos]
