"""N-gram LM scorer for shallow fusion (KenLM replacement).

Port of espnet_slurp_tpu/decode/ngram.py. ``ArpaLM`` (the ARPA reader, orders
1-3, ``.gz`` input, the ``.npz`` binary cache) is host numpy, copied; the
per-step scorer is torch on the decode's device: ``torch.searchsorted`` over
the sorted context keys, and each context's sparse row scattered into a
[N, V + 1] buffer whose column V takes the padding slots (the dump column).
Context keys are int64 (``c1 * V + c2``).

Backoff recursion (Katz / ARPA), evaluated for every word at once:
    level2(c2)[w]   = lp2(c2, w)       if (c2, w) exists
                      else bo(c2) + lp1(w)
    p(w | c1, c2)[w] = lp3(c1, c2, w)  if (c1, c2, w) exists
                      else bo(c1, c2) + level2(c2)[w]
so a full [V] row is: (uni + bo(c2)) overwritten by the bigram row of c2,
plus bo(c1, c2), overwritten by the trigram row of (c1, c2): two sparse-row
scatters a step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

LOG10 = math.log(10.0)
NEG = -1e30


def _sparse_rows(rows: Dict[int, List[Tuple[int, float]]]):
    """{ctx_key: [(word, logp)]} -> sorted flat tables."""
    keys = np.asarray(sorted(rows), np.int64) if rows else \
        np.asarray([-1], np.int64)
    offs = np.zeros(len(keys), np.int64)
    lens = np.zeros(len(keys), np.int64)
    words: List[int] = []
    lps: List[float] = []
    for i, k in enumerate(sorted(rows)):
        offs[i] = len(words)
        lens[i] = len(rows[k])
        for w, lp in sorted(rows[k]):
            words.append(w)
            lps.append(lp)
    if not words:
        words, lps = [0], [0.0]
    return (keys, offs, lens, np.asarray(words, np.int32),
            np.asarray(lps, np.float32))


#: arrays persisted by the binary cache (everything scoring needs)
_BINARY_FIELDS = ("uni", "uni_bo", "bi_ctx", "bi_off", "bi_len", "bi_w",
                  "bi_lp", "tri_ctx", "tri_off", "tri_len", "tri_w",
                  "tri_lp", "bi_bo_key", "bi_bo")


class ArpaLM:
    """ARPA file (orders 1-3) over a token-id vocabulary.

    ``token_to_id`` maps ARPA words to decoder token ids (map <s>/</s> to
    the decoder's sos/eos); OOV ARPA entries are dropped. ``.gz`` ARPA
    files are read transparently. For big LMs, compile once with
    ``save_binary`` and start instantly with ``ArpaLM.load_binary`` —
    the KenLM ``build_binary`` analogue (reference scorers/ngram.py loads
    KenLM binaries; the compiled tables here ARE the scorer's runtime
    format, so the cache is exact).
    """

    def __init__(self, path: str, token_to_id: Dict[str, int],
                 vocab_size: int):
        if path.endswith((".npz", ".bin")):  # compiled cache, not ARPA text
            self._load_arrays(path, vocab_size)
            return
        self.v = vocab_size
        self.uni = np.full((vocab_size,), np.log(1e-10), np.float32)
        self.uni_bo = np.zeros((vocab_size,), np.float32)
        bi_rows: Dict[int, List] = {}
        bi_bo: Dict[int, float] = {}
        tri_rows: Dict[int, List] = {}
        order = 0
        if path.endswith(".gz"):
            import gzip
            opener = lambda p: gzip.open(p, "rt", encoding="utf-8",
                                         errors="replace")
        else:
            opener = lambda p: open(p, encoding="utf-8", errors="replace")
        with opener(path) as f:
            for raw in f:
                line = raw.strip()
                if line.startswith("\\") and "-grams:" in line:
                    order = int(line[1])
                    continue
                if not line or line.startswith("\\") or line.startswith(
                        "ngram "):
                    continue
                parts = line.replace("\t", " ").split()
                if len(parts) < order + 1 or order == 0:
                    continue
                try:
                    lp = float(parts[0]) * LOG10
                except ValueError:
                    continue
                words = parts[1:1 + order]
                bo = 0.0
                if len(parts) > order + 1:
                    try:
                        bo = float(parts[order + 1]) * LOG10
                    except ValueError:
                        bo = 0.0
                ids = [token_to_id.get(w, -1) for w in words]
                if any(i < 0 for i in ids):
                    continue
                if order == 1:
                    if words[0] == "<s>":
                        # <s> is context-only (ARPA logp -99, never
                        # predicted). With a JOINT sos/eos id (the usual
                        # decoder wiring) the shared slot must keep
                        # p(</s>) for prediction and take <s>'s backoff
                        # weight for its role as context — writing the
                        # -99 would clobber the eos probability.
                        self.uni_bo[ids[0]] = bo
                    else:
                        self.uni[ids[0]] = lp
                        self.uni_bo[ids[0]] = bo
                elif order == 2:
                    bi_rows.setdefault(ids[0], []).append((ids[1], lp))
                    if bo != 0.0:
                        bi_bo[ids[0] * vocab_size + ids[1]] = bo
                elif order == 3:
                    tri_rows.setdefault(
                        ids[0] * vocab_size + ids[1], []).append(
                            (ids[2], lp))
        (self.bi_ctx, self.bi_off, self.bi_len, self.bi_w,
         self.bi_lp) = _sparse_rows(bi_rows)
        (self.tri_ctx, self.tri_off, self.tri_len, self.tri_w,
         self.tri_lp) = _sparse_rows(tri_rows)
        self.bi_bo_key = np.asarray(sorted(bi_bo), np.int64) if bi_bo \
            else np.asarray([-1], np.int64)
        self.bi_bo = np.asarray([bi_bo[k] for k in sorted(bi_bo)],
                                np.float32) if bi_bo else \
            np.zeros((1,), np.float32)
        self.max_row = int(max(
            1, self.bi_len.max() if len(self.bi_len) else 1,
            self.tri_len.max() if len(self.tri_len) else 1))

    def save_binary(self, path: str) -> None:
        """Compile to a binary cache (kenlm build_binary analogue): one
        uncompressed .npz of the flat scoring tables; loading skips the
        ARPA parse entirely."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 v=np.int64(self.v), max_row=np.int64(self.max_row),
                 **{k: getattr(self, k) for k in _BINARY_FIELDS})

    def _load_arrays(self, path: str, vocab_size: int) -> None:
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        self.v = int(z["v"])
        if vocab_size and vocab_size != self.v:
            raise ValueError(
                f"binary ngram was compiled for vocab {self.v}, "
                f"decoder has {vocab_size}")
        self.max_row = int(z["max_row"])
        for k in _BINARY_FIELDS:
            setattr(self, k, z[k])

    @classmethod
    def load_binary(cls, path: str) -> "ArpaLM":
        lm = cls.__new__(cls)
        lm._load_arrays(path, 0)
        return lm


def _lookup(keys: torch.Tensor, vals: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """vals[keys == q] per query, 0.0 where the key is absent."""
    i = torch.searchsorted(keys, q).clamp(0, keys.shape[0] - 1)
    return torch.where(keys[i] == q, vals[i], torch.zeros_like(vals[i]))


def _scatter_row(base: torch.Tensor, ctx_keys, offs, lens, tbl_w, tbl_lp,
                 key: torch.Tensor, max_row: int) -> torch.Tensor:
    """base [N, V] overwritten with the sparse row of ``key`` [N]."""
    n, v = base.shape
    i = torch.searchsorted(ctx_keys, key).clamp(0, ctx_keys.shape[0] - 1)
    found = ctx_keys[i] == key
    ln = torch.where(found, lens[i], torch.zeros_like(lens[i]))
    slots = torch.arange(max_row, device=base.device)[None, :]
    take = (offs[i][:, None] + slots).clamp(0, tbl_w.shape[0] - 1)
    valid = slots < ln[:, None]
    words = torch.where(valid, tbl_w[take], v)  # V = the dump column
    vals = torch.where(valid, tbl_lp[take], 0.0)
    out = torch.cat([base, base.new_zeros(n, 1)], dim=1)
    # every padding slot writes the dump column, which is dropped
    return out.scatter(1, words, vals)[:, :v]


_TABLES = ("uni", "uni_bo", "bi_ctx", "bi_off", "bi_len", "bi_w", "bi_lp",
           "tri_ctx", "tri_off", "tri_len", "tri_w", "tri_lp", "bi_bo_key",
           "bi_bo")


def make_ngram_fusion(lm: ArpaLM, sos_id: int, device=None
                      ) -> Tuple[Callable, Callable]:
    """(lm_step, lm_init) hooks of decode/beam.py's shallow fusion, with the
    scoring tables on ``device`` (the card unless given). The state is the
    two-token context {"c1", "c2"}, both sos at the start."""
    dev = resolve_device(device)
    v = lm.v
    mr = lm.max_row
    t = {}
    for k in _TABLES:
        x = torch.from_numpy(np.asarray(getattr(lm, k)))
        t[k] = x.to(dev, torch.int64 if x.dtype in (torch.int32, torch.int64)
                    else torch.float32)

    def lm_init(n):
        return {"c1": torch.full((n,), sos_id, dtype=torch.long, device=dev),
                "c2": torch.full((n,), sos_id, dtype=torch.long, device=dev)}

    def lm_step(y_prev, state):
        c1 = state["c2"]
        c2 = y_prev.long()
        n = c2.shape[0]
        base = (t["uni"][None, :] + t["uni_bo"][c2][:, None]).expand(n, v)
        row = _scatter_row(base, t["bi_ctx"], t["bi_off"], t["bi_len"],
                           t["bi_w"], t["bi_lp"], c2, mr)
        key12 = c1 * v + c2
        row = row + _lookup(t["bi_bo_key"], t["bi_bo"], key12)[:, None]
        row = _scatter_row(row, t["tri_ctx"], t["tri_off"], t["tri_len"],
                           t["tri_w"], t["tri_lp"], key12, mr)
        return row, {"c1": c1, "c2": c2}

    return lm_step, lm_init
