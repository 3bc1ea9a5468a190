"""Error-rate scoring (WER/CER) — the sclite/sctk replacement. Port of
espnet_slurp_tpu/utils/metrics.py: ``ErrorStats``, ``align_stats`` and
``error_rate`` with its native fast path (native/edit_distance.cpp) and
``rare_word_error_rate`` (how contextual biasing is scored); BLEU comes
with the tasks that use it.

Parity target: stage-13 scoring in egs2/TEMPLATE/asr1/asr.sh:1276-1396 (sclite
alignment + WER). Pure-python Levenshtein with alignment counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple


@dataclass
class ErrorStats:
    hits: int = 0
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0

    @property
    def ref_len(self) -> int:
        return self.hits + self.substitutions + self.deletions

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def error_rate(self) -> float:
        return self.errors / max(self.ref_len, 1)

    def __add__(self, other: "ErrorStats") -> "ErrorStats":
        return ErrorStats(self.hits + other.hits,
                          self.substitutions + other.substitutions,
                          self.deletions + other.deletions,
                          self.insertions + other.insertions)


def align_stats(ref: Sequence, hyp: Sequence) -> ErrorStats:
    """Levenshtein alignment counts between token sequences."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, subs, dels, ins)
    INF = 10**9
    prev = [(j, 0, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            # substitution / hit
            c, h, s, d, ins = prev[j - 1]
            if ref[i - 1] == hyp[j - 1]:
                best = (c, h + 1, s, d, ins)
            else:
                best = (c + 1, h, s + 1, d, ins)
            # deletion
            c, h, s, d, ins = prev[j]
            if c + 1 < best[0]:
                best = (c + 1, h, s, d + 1, ins)
            # insertion
            c, h, s, d, ins = cur[j - 1]
            if c + 1 < best[0]:
                best = (c + 1, h, s, d, ins + 1)
            cur[j] = best
        prev = cur
    _, h, s, d, ins = prev[m]
    return ErrorStats(h, s, d, ins)


def error_rate(refs: Dict[str, str], hyps: Dict[str, str],
               unit: str = "word") -> Tuple[float, ErrorStats]:
    """Corpus WER (unit='word') or CER (unit='char').

    Fast path: the native C++ batch scorer (native/edit_distance.cpp, the
    sclite-analogue hot loop) with identical tie-breaking; falls back to
    the python DP when the toolchain is unavailable.
    """
    pairs = []
    for uid, ref in refs.items():
        hyp = hyps.get(uid, "")
        if unit == "word":
            pairs.append((ref.split(), hyp.split()))
        else:
            pairs.append((list(ref.replace(" ", "")),
                          list(hyp.replace(" ", ""))))
    # Tokens -> ids for the int-based native kernel.
    from ..native import edit_stats_batch
    vocab: Dict[str, int] = {}

    def ids(tokens):
        return [vocab.setdefault(t, len(vocab)) for t in tokens]

    stats = edit_stats_batch([ids(r) for r, _ in pairs],
                             [ids(h) for _, h in pairs]) \
        if pairs else None
    total = ErrorStats()
    if stats is not None:
        for h, s, d, i in stats:
            total = total + ErrorStats(int(h), int(s), int(d), int(i))
    else:
        for r, h in pairs:
            total = total + align_stats(r, h)
    return total.error_rate, total


def rare_word_error_rate(refs: Dict[str, str], hyps: Dict[str, str],
                         rare_words) -> Tuple[float, float, ErrorStats,
                                              ErrorStats]:
    """WER split into rare (biasing-list) vs common words.

    Parity target: the fork's rare-word scorer
    espnet/nets/pytorch_backend/KB_utils/wer.py (197 LoC): aligns ref/hyp,
    then attributes each ref-word slot to the rare or common bucket.
    Returns (rare_wer, common_wer, rare_stats, common_stats).
    """
    rare_set = set(rare_words)
    rare = ErrorStats()
    common = ErrorStats()
    for uid, ref in refs.items():
        r = ref.split()
        h = hyps.get(uid, "").split()
        # alignment backtrace
        n, m = len(r), len(h)
        dp = [[0] * (m + 1) for _ in range(n + 1)]
        for i in range(n + 1):
            dp[i][0] = i
        for j in range(m + 1):
            dp[0][j] = j
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                dp[i][j] = min(
                    dp[i - 1][j - 1] + (r[i - 1] != h[j - 1]),
                    dp[i - 1][j] + 1, dp[i][j - 1] + 1)
        i, j = n, m
        while i > 0 or j > 0:
            if i > 0 and j > 0 and \
                    dp[i][j] == dp[i - 1][j - 1] + (r[i - 1] != h[j - 1]):
                bucket = rare if r[i - 1] in rare_set else common
                if r[i - 1] == h[j - 1]:
                    bucket.hits += 1
                else:
                    bucket.substitutions += 1
                i, j = i - 1, j - 1
            elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
                bucket = rare if r[i - 1] in rare_set else common
                bucket.deletions += 1
                i -= 1
            else:
                common.insertions += 1
                j -= 1
    return rare.error_rate, common.error_rate, rare, common
