"""Text cleaners applied before tokenization: this package's own copy of
espnet_slurp_tpu/data/cleaner.py.

Parity target: espnet2/text/cleaner.py (TextCleaner dispatching to
tacotron_cleaner.cleaners.custom_english_cleaners / jaconv.normalize /
KoreanCleaner). The reference pulls external packages for each cleaner
type; here the cleaners are implemented in-framework so the data pipeline
has no host-side native/third-party dependency:

- ``tacotron``  — english_cleaners analogue (keithito text pipeline as
  used by tacotron_cleaner): unicode->ascii fold, number expansion,
  abbreviation expansion, punctuation simplification, whitespace
  collapse, uppercase (the reference's custom_english_cleaners uppercases,
  see espnet2/text/cleaner.py:18-22 docstring example).
- ``jaconv``    — jaconv.normalize analogue: NFKC unicode normalization
  (full-width -> half-width ascii, half-width kana -> full-width) plus
  the tilde/dash unifications jaconv applies on top of NFKC.
- ``lowercase`` / ``uppercase`` / ``whitespace`` — building-block cleaners.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List, Sequence, Union

# keithito english_cleaners abbreviation table (dot REQUIRED, as in the
# original pipeline — "\bco\b" without the dot would corrupt e.g. "cold")
_ABBREV = [(re.compile(r"\b%s\." % a, re.IGNORECASE), b) for a, b in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"),
    ("ft", "fort"),
]]

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
          (100, "hundred")]


def _num_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + _num_to_words(-n)
    parts: List[str] = []
    for value, name in _SCALE:
        if n >= value:
            parts.append(_num_to_words(n // value) + " " + name)
            n %= value
    if n >= 20:
        t = _TENS[n // 10]
        parts.append(t + (" " + _ONES[n % 10] if n % 10 else ""))
    elif n:
        parts.append(_ONES[n])
    return " ".join(parts)


def _expand_numbers(text: str) -> str:
    def words(s: str) -> str:
        s = s.replace(",", "")
        if "." in s:
            whole, frac = s.split(".", 1)
            w = _num_to_words(int(whole)) if whole else "zero"
            return w + " point " + " ".join(_num_to_words(int(d))
                                            for d in frac)
        return _num_to_words(int(s))

    text = re.sub(r"\$(\d[\d,]*(?:\.\d+)?)",
                  lambda m: words(m.group(1)) + " dollars", text)
    return re.sub(r"\d[\d,]*(?:\.\d+)?", lambda m: words(m.group(0)), text)


def _to_ascii(text: str) -> str:
    return unicodedata.normalize("NFKD", text).encode(
        "ascii", "ignore").decode("ascii")


def tacotron_clean(text: str) -> str:
    """custom_english_cleaners analogue (see module docstring)."""
    text = _to_ascii(text)
    for pat, sub in _ABBREV:
        text = pat.sub(sub, text)
    text = _expand_numbers(text)
    text = text.replace("&", " and ")
    # punctuation simplification: clause separators become commas, the
    # rest (quotes/brackets/hyphens) become plain spaces
    text = re.sub(r"[;:—()\[\]{}\"]", ",", text)
    text = re.sub(r"[-_/]", " ", text)
    text = re.sub(r"[^A-Za-z0-9,.!?' ]", "", text)
    text = re.sub(r"\s*,[\s,]*", ", ", text)  # collapse comma runs
    text = re.sub(r"\s+", " ", text).strip()
    text = re.sub(r"[,.\s]+$", "", text)  # trailing separators
    text = re.sub(r"^[,.\s]+", "", text)  # leading separators
    return text.upper()


def jaconv_clean(text: str) -> str:
    """jaconv.normalize analogue: NFKC + tilde/dash unification."""
    text = text.replace("〜", "ー").replace("~", "ー") \
        if _has_kana(text) else text
    text = unicodedata.normalize("NFKC", text)
    # unify hyphen-like codepoints to the long vowel mark inside kana runs
    text = re.sub(r"[‐‑‒–─━ー]",
                  lambda m: "ー" if _has_kana(text) else "-", text)
    return text


def _has_kana(text: str) -> bool:
    return any("぀" <= c <= "ヿ" for c in text)


class TextCleaner:
    """espnet2/text/cleaner.py:TextCleaner analogue.

    >>> TextCleaner("tacotron")("(Hello-World);   &  jr. & dr.")
    'HELLO WORLD, AND JUNIOR AND DOCTOR'
    """

    def __init__(self, cleaner_types: Union[str, Sequence[str], None] = None):
        if cleaner_types is None:
            cleaner_types = []
        elif isinstance(cleaner_types, str):
            cleaner_types = [cleaner_types]
        self.cleaner_types = [t for t in cleaner_types if t]
        for t in self.cleaner_types:
            if t not in ("tacotron", "jaconv", "lowercase", "uppercase",
                         "whitespace"):
                raise ValueError(f"unknown cleaner type {t}")

    def __call__(self, text: str) -> str:
        for t in self.cleaner_types:
            if t == "tacotron":
                text = tacotron_clean(text)
            elif t == "jaconv":
                text = jaconv_clean(text)
            elif t == "lowercase":
                text = text.lower()
            elif t == "uppercase":
                text = text.upper()
            elif t == "whitespace":
                text = re.sub(r"\s+", " ", text).strip()
        return text
