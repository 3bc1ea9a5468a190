"""Count-based backoff n-gram LM estimation -> ARPA text.

Port of espnet_slurp_tpu/decode/ngram_train.py: a copy (plain Python),
so that the ARPA it writes is the reference's byte for byte.

The reference trains its n-gram fusion LMs with EXTERNAL KenLM
(tools/installers/install_kenlm.sh; egs2 recipes call lmplz / build_binary)
and only loads them at decode (espnet/nets/scorers/ngram.py). This module
closes the training side in-framework: absolute-discounting Katz backoff
estimation (the lmplz default family) over any tokenized text, emitting
standard ARPA that decode/ngram.py's ArpaLM (and hence
``asr_inference --ngram_file``) consumes directly — no external toolchain.

Model: for each history h with observed continuations,
    p*(w|h)   = (c(h,w) - D) / c(h)                      (discounted ML)
    alpha(h)  = [D * N1+(h) / c(h)]
                / [1 - sum_{w: c(h,w)>0} p(w|h')]        (Katz backoff,
                                                          renormalized)
    p(w|h)    = p*(w|h)                if c(h,w) > 0
              = alpha(h) * p(w|h')     otherwise (h' = h[1:])
so every context's distribution sums to 1 (tested against ArpaLM's
scoring tables). ARPA stores log10 p* on each n-gram row and log10
alpha(h) as the backoff weight on the (n-1)-gram row of h.
"""
from __future__ import annotations

import math
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Sequence


def train_arpa(sentences: Iterable[Sequence[str]], out_path: str | Path,
               order: int = 3, discount: float = 0.75,
               sos: str = "<s>", eos: str = "</s>") -> Path:
    """Estimate an `order`-gram backoff LM from tokenized sentences.

    sentences: iterable of token sequences (NO sos/eos; added here).
    Writes ARPA text to out_path and returns it. Unseen-word mass at the
    unigram level goes to ``<unk>`` (always emitted), so the model is a
    proper distribution over its closed vocabulary + unk.
    """
    assert 1 <= order <= 3, "ArpaLM consumes up to trigrams"
    counts = [Counter() for _ in range(order)]  # n-gram -> count
    for sent in sentences:
        toks = [sos] + list(sent) + [eos]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                g = tuple(toks[i:i + n])
                if n == 1 and g == (sos,):
                    continue  # <s> is context-only, never predicted
                counts[n - 1][g] += 1
    counts[0][(sos,)] = 0  # present in vocab with -99 logp (ARPA custom)
    counts[0][("<unk>",)] = 0

    # context totals per history
    ctx_total = [Counter() for _ in range(order)]
    for n in range(2, order + 1):
        for g, c in counts[n - 1].items():
            ctx_total[n - 1][g[:-1]] += c

    d = float(discount)
    probs: List[dict] = [dict() for _ in range(order)]
    backoff: List[dict] = [dict() for _ in range(order)]

    # Unigrams: discounted ML over the running-word total; released mass
    # (+ any <s>/zero rows) -> <unk>.
    uni_total = sum(counts[0].values())
    n_seen = sum(1 for c in counts[0].values() if c > 0)
    for g, c in counts[0].items():
        if c > 0:
            probs[0][g] = (c - d) / uni_total
    probs[0][("<unk>",)] = max(d * n_seen / uni_total, 1e-10)
    probs[0][(sos,)] = 1e-99  # ARPA convention: logp(<s>) = -99

    def lower_prob(g):
        """Full backed-off p(w | h') for g = h' + (w,), accumulating the
        alphas of every backoff hop taken (needs backoff[] of strictly
        lower orders, available because n ascends below)."""
        alpha = 1.0
        while len(g) > 1 and g not in probs[len(g) - 1]:
            alpha *= backoff[len(g) - 2].get(g[:-1], 1.0)
            g = g[1:]
        if len(g) == 1:
            return alpha * probs[0].get(g, probs[0][("<unk>",)])
        return alpha * probs[len(g) - 1][g]

    for n in range(2, order + 1):
        by_ctx: dict = {}
        for g, c in counts[n - 1].items():
            probs[n - 1][g] = (c - d) / ctx_total[n - 1][g[:-1]]
            by_ctx.setdefault(g[:-1], []).append(g[-1])
        for h, ws in by_ctx.items():
            released = d * len(ws) / ctx_total[n - 1][h]
            # Katz renormalization: divide by the lower-order mass that
            # actually backs off (1 - lower-order mass of the seen set).
            seen_lower = sum(lower_prob(h[1:] + (w,)) for w in ws)
            denom = max(1.0 - seen_lower, 1e-10)
            # alpha lives as the backoff weight of the (n-1)-gram row h
            backoff[n - 2][h] = released / denom

    def lg(x: float) -> float:
        return math.log10(max(x, 1e-99))

    out_path = Path(out_path)
    with open(out_path, "w") as f:
        f.write("\\data\\\n")
        for n in range(order):
            f.write(f"ngram {n + 1}={len(probs[n])}\n")
        for n in range(order):
            f.write(f"\n\\{n + 1}-grams:\n")
            for g in sorted(probs[n]):
                row = f"{lg(probs[n][g]):.6f}\t{' '.join(g)}"
                if n < order - 1 and g in backoff[n]:
                    row += f"\t{lg(backoff[n][g]):.6f}"
                f.write(row + "\n")
        f.write("\n\\end\\\n")
    return out_path


def train_arpa_from_file(text_path: str | Path, out_path: str | Path,
                         order: int = 3, tokenizer=None,
                         skip_first_column: bool = True, **kw) -> Path:
    """Kaldi-style ``text`` (uttid w1 w2 ...) -> ARPA. tokenizer: optional
    callable str -> list[str] (e.g. BPE pieces); default whitespace words."""
    sents = []
    for line in Path(text_path).read_text().splitlines():
        parts = line.split()
        if skip_first_column:
            parts = parts[1:]
        if tokenizer is not None:
            parts = tokenizer(" ".join(parts))
        if parts:
            sents.append(parts)
    return train_arpa(sents, out_path, order=order, **kw)
