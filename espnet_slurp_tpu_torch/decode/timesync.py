"""Time-synchronous CTC prefix beam search (+ attention rescoring).

Port of espnet_slurp_tpu/decode/timesync.py. The classic CTC prefix beam
(Hannun et al.): per frame each prefix keeps its blank- and
non-blank-ending log-probabilities; blanks and repeats merge implicitly.
Fixed [B, K] beam state and [B, K, 1 + P] candidates (stay, and the top P
non-blank extensions) a frame; the reference's ``fori_loop`` over the
padded frames is a Python loop over the longest utterance's frames (the
frames past every length change nothing). As in the reference, duplicate
prefixes reached from different parents are not merged, and the attention
decoder rescores the final beam (``att_weight``) rather than each
expansion.

Both top-k selections take the lower index first on a tie, as
``lax.top_k`` does (a stable descending sort, decode/beam.py:_top_k):
until the beam fills, the dead slots tie at NEG on every frame, and the
card's ``torch.topk`` promises no order among them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .beam import _top_k

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class TimeSyncConfig:
    beam_size: int = 10
    pre_beam_size: int = 8     # non-blank extensions per hypothesis/frame
    max_len: int = 128
    att_weight: float = 0.0    # > 0: rescore the final beam with the decoder


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b).clamp_min(NEG)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


@torch.inference_mode()
def ctc_prefix_beam_full(model, hs: torch.Tensor, h_lengths: torch.Tensor,
                         cfg: TimeSyncConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame-synchronous CTC prefix beam returning the FULL final beam:
    (tokens [B, K, max_len] blank-padded, lengths [B, K], ctc_scores [B, K]
    fp32), the n-best paths that decode/lattice.py rescores."""
    mcfg = model.cfg
    blank = mcfg.blank_id
    b, t_max, _ = hs.shape
    k, l = cfg.beam_size, cfg.max_len
    p = min(cfg.pre_beam_size, mcfg.vocab_size - 1)
    n = b * k
    dev = hs.device
    ctc_lp = model.ctc_logprobs(hs)  # [B, T, V] fp32
    hl = h_lengths.to(dev)
    tokens = torch.full((n, l), blank, dtype=torch.long, device=dev)
    n_emit = torch.zeros(n, dtype=torch.long, device=dev)
    # only beam slot 0 is live at first (the empty prefix)
    slot0 = (torch.arange(k, device=dev) == 0).repeat(b)
    p_b = torch.where(slot0, 0.0, NEG).float()
    p_nb = torch.full((n,), NEG, device=dev)
    rows = (torch.arange(b, device=dev) * k)[:, None]
    pos = torch.arange(l, device=dev)[None, :]
    live_len = hl.repeat_interleave(k)
    for t in range(int(hl.max()) if b else 0):
        lp_k = ctc_lp[:, t].repeat_interleave(k, dim=0)  # [N, V]
        last = tokens.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
        has_last = n_emit > 0
        tot = _lse(p_b, p_nb)
        # stay: blank after anything, or a repeat of the last label
        stay_b = tot + lp_k[:, blank]
        rep_lp = lp_k.gather(1, last[:, None])[:, 0]
        stay_nb = torch.where(has_last, p_nb + rep_lp,
                              torch.full_like(p_nb, NEG))
        stay = _lse(stay_b, stay_nb)
        # extensions: the top P non-blank tokens
        nb = lp_k.clone()
        nb[:, blank] = NEG
        top_lp, top_id = _top_k(nb, p)  # [N, P]
        base = torch.where((top_id == last[:, None]) & has_last[:, None],
                           p_b[:, None], tot[:, None])
        ext = torch.where((n_emit < l)[:, None], base + top_lp,
                          torch.full_like(top_lp, NEG))
        flat = torch.cat([stay[:, None], ext], 1).reshape(b, k * (p + 1))
        _, idx = _top_k(flat, k)
        parent = (idx // (p + 1) + rows).reshape(n)
        choice = (idx % (p + 1)).reshape(n)
        is_stay = choice == 0
        ch = (choice - 1).clamp_min(0)[:, None]
        tok = top_id[parent].gather(1, ch)[:, 0]
        tokens_g, n_g = tokens[parent], n_emit[parent]
        write = ~is_stay[:, None] & (pos == n_g.clamp(max=l - 1)[:, None])
        new_tokens = torch.where(write, tok[:, None], tokens_g)
        new_n = n_g + (~is_stay).long()
        new_p_b = torch.where(is_stay, stay_b[parent],
                              torch.full_like(p_b, NEG))
        new_p_nb = torch.where(is_stay, stay_nb[parent],
                               ext[parent].gather(1, ch)[:, 0])
        # freeze past each utterance's length
        live = t < live_len
        tokens = torch.where(live[:, None], new_tokens, tokens)
        n_emit = torch.where(live, new_n, n_emit)
        p_b = torch.where(live, new_p_b, p_b)
        p_nb = torch.where(live, new_p_nb, p_nb)
    return (tokens.reshape(b, k, l), n_emit.reshape(b, k),
            _lse(p_b, p_nb).reshape(b, k))


def pick_best(tokens: torch.Tensor, lengths: torch.Tensor,
              total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's best path by ``total`` [B, K] (the first on a tie, as
    jnp.argmax): (tokens [B, L], lengths [B])."""
    best = total.argmax(dim=1)
    r = torch.arange(tokens.shape[0], device=tokens.device)
    return tokens[r, best], lengths[r, best]


@torch.inference_mode()
def ctc_timesync_beam_search(model, hs: torch.Tensor, h_lengths: torch.Tensor,
                             cfg: TimeSyncConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CTC prefix beam's best path (after the decoder's n-best
    rescoring at ``att_weight`` > 0): (tokens [B, max_len] blank-padded,
    lengths [B])."""
    tokens, n_emit, total = ctc_prefix_beam_full(model, hs, h_lengths, cfg)
    if cfg.att_weight > 0.0:
        from ..train.mbr import hyp_scores
        att = hyp_scores(model, hs, h_lengths, tokens, n_emit)
        total = (1.0 - cfg.att_weight) * total + cfg.att_weight * att
    return pick_best(tokens, n_emit, total)
