"""CTC segmentation: forced alignment of a known transcript to audio.

Port of espnet_slurp_tpu/decode/ctc_segmentation.py (this package's own
copy): ``ctc_viterbi_align`` and ``align_words``. Host-side Viterbi over
the blank-interleaved state lattice with backpointers, in numpy: an
offline tool (bin/asr_align.py computes the posteriors on the card).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def ctc_viterbi_align(log_probs: np.ndarray, tokens: List[int],
                      blank_id: int = 0) -> List[Tuple[int, int, float]]:
    """Best CTC alignment path -> per-token (start_frame, end_frame, conf).

    log_probs: [T, V] CTC log-posteriors; tokens: label sequence.
    conf = mean token log-prob over its frames (exp'd to probability).
    """
    t_max, _ = log_probs.shape
    u = len(tokens)
    if u == 0:
        return []
    s = 2 * u + 1
    ext = np.full((s,), blank_id, np.int64)
    ext[1::2] = tokens
    allow_skip = np.zeros((s,), bool)
    allow_skip[2:] = (ext[2:] != blank_id) & (ext[2:] != ext[:-2])

    neg = -1e30
    dp = np.full((s,), neg)
    dp[0] = log_probs[0, ext[0]]
    if s > 1:
        dp[1] = log_probs[0, ext[1]]
    bp = np.zeros((t_max, s), np.int8)  # 0 stay, 1 from s-1, 2 from s-2
    for t in range(1, t_max):
        prev = dp
        stay = prev
        diag = np.concatenate([[neg], prev[:-1]])
        skip = np.concatenate([[neg, neg], prev[:-2]])
        skip = np.where(allow_skip, skip, neg)
        best = np.maximum(stay, np.maximum(diag, skip))
        bp[t] = np.where(skip == best, 2,
                         np.where(diag == best, 1, 0))
        dp = best + log_probs[t, ext]

    # end at S-1 (trailing blank) or S-2 (last label)
    end_state = s - 1 if dp[s - 1] >= dp[s - 2] else s - 2
    states = np.zeros((t_max,), np.int64)
    cur = end_state
    for t in range(t_max - 1, -1, -1):
        states[t] = cur
        cur = cur - bp[t, cur]

    out = []
    for i in range(u):
        st = 2 * i + 1
        frames = np.nonzero(states == st)[0]
        if frames.size == 0:
            out.append((0, 0, 0.0))
            continue
        conf = float(np.exp(np.mean(log_probs[frames, tokens[i]])))
        out.append((int(frames[0]), int(frames[-1]) + 1, conf))
    return out


def align_words(token_timings, token_strs, boundary_suffix="▁",
                space_token="<space>"):
    """Merge token timings into word (start, end, conf, word) tuples.

    A word ends at a token ending with the sentencepiece boundary mark or
    at an explicit space token (which itself is dropped).
    """
    words = []
    buf: List[str] = []
    start = None
    confs: List[float] = []
    end = 0
    for (s, e, c), tok in zip(token_timings, token_strs):
        if tok == space_token:
            if buf:
                words.append((start, end, float(np.mean(confs)),
                              "".join(buf)))
                buf, confs, start = [], [], None
            continue
        if start is None:
            start = s
        buf.append(tok.replace(boundary_suffix, ""))
        confs.append(c)
        end = e
        if tok.endswith(boundary_suffix):
            words.append((start, end, float(np.mean(confs)), "".join(buf)))
            buf, confs, start = [], [], None
    if buf:
        words.append((start, end, float(np.mean(confs)), "".join(buf)))
    return words
