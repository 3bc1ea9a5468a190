"""Vectorised CTC prefix scoring for joint CTC/attention beam search.

Port of espnet_slurp_tpu/decode/ctc_prefix.py (Watanabe et al. hybrid
CTC/attention; reference espnet/nets/ctc_prefix_score.py). For prefix g and
extension c, in log space:
  r_nb(t) = (r_nb(t-1) (+) phi(t-1)) * x_t(c)
  r_b(t)  = (r_b(t-1) (+) r_nb(t-1)) * x_t(blank)
  psi     = (+)_t phi(t-1) * x_t(c)
with phi(t) = r_b^g(t) (+) [c != last(g)] r_nb^g(t).

The reference's ``lax.scan`` over frames is a Python loop over T' here,
three small ops per frame per beam step: the likely host-launch hot spot of
decoding on the card (a kernel or a CUDA graph is later work). The
recursion keeps (phi, r_nb, r_b) of every frame in one [T, 3, N, P] buffer
Z so that both log-adds of a frame read views of the previous frame:
(r_nb, r_b)(t) = lse(Z[t-1, 1:3], Z[t-1, 0:2]) + (x_c, x_b)(t).
``psi`` does not feed the recursion and is one logsumexp over frames.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG_INF = -1e30


class CTCPrefixState(NamedTuple):
    """r: [N, T, 2] log forward variables (..., 0] non-blank, ..., 1]
    blank); psi: [N] prefix log-prob; last: [N] last token (-1 if empty)."""
    r: torch.Tensor
    psi: torch.Tensor
    last: torch.Tensor


def masked_blank(ctc_lp: torch.Tensor, lengths: torch.Tensor,
                 blank_id: int = 0) -> torch.Tensor:
    """Blank log-probs [N, T] with frames past ``lengths`` set to 0 (log 1),
    so the lattice carries through padding."""
    t = ctc_lp.shape[1]
    valid = torch.arange(t, device=ctc_lp.device)[None, :] < lengths[:, None]
    blank = ctc_lp[:, :, blank_id]
    return torch.where(valid, blank, torch.zeros_like(blank))


def init_state(ctc_lp: torch.Tensor, lengths: torch.Tensor,
               blank_id: int = 0) -> CTCPrefixState:
    """ctc_lp: [N, T, V] CTC log-softmax; lengths: [N] valid frames."""
    n, t, _ = ctc_lp.shape
    r_b = torch.cumsum(masked_blank(ctc_lp, lengths, blank_id), dim=1)
    r_nb = torch.full_like(r_b, NEG_INF)
    return CTCPrefixState(
        r=torch.stack([r_nb, r_b], dim=-1),
        psi=torch.zeros(n, device=ctc_lp.device),
        last=torch.full((n,), -1, dtype=torch.long, device=ctc_lp.device))


def score_candidates(state: CTCPrefixState, ctc_lp: torch.Tensor,
                     lengths: torch.Tensor, cand: torch.Tensor,
                     prefix_len: int, blank_id: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores P candidate extensions of each of N prefixes.

    ctc_lp [N, T, V]; lengths [N]; cand [N, P] token ids; prefix_len is 0
    iff the prefixes are empty. Returns psi_new [N, P] and the extended
    lattices r_new [N, P, T, 2] (a view; gather the chosen ones)."""
    n, t, _ = ctc_lp.shape
    p = cand.shape[1]
    neg = torch.full((), NEG_INF, device=ctc_lp.device)
    valid = torch.arange(t, device=ctc_lp.device)[None, :, None] \
        < lengths[:, None, None]
    x_c = torch.where(valid, ctc_lp.gather(
        2, cand[:, None, :].expand(n, t, p)), neg)  # [N, T, P]
    x_b = masked_blank(ctc_lp, lengths, blank_id)  # [N, T]
    r_nb_g, r_b_g = state.r[..., 0], state.r[..., 1]
    same = (cand == state.last[:, None])[:, None, :]  # repeated label
    phi = torch.where(same, r_b_g[:, :, None],
                      torch.logaddexp(r_b_g, r_nb_g)[:, :, None])  # [N,T,P]

    z = torch.empty(t, 3, n, p, device=ctc_lp.device)
    z[:, 0] = phi.permute(1, 0, 2)
    z[0, 1] = x_c[:, 0] if prefix_len == 0 else neg
    z[0, 2] = neg
    x = torch.stack([x_c.permute(1, 0, 2),
                     x_b.t()[:, :, None].expand(t, n, p)], dim=1)  # [T,2,N,P]
    for i in range(1, t):
        torch.logaddexp(z[i - 1, 1:3], z[i - 1, 0:2], out=z[i, 1:3])
        z[i, 1:3] += x[i]
        z[i, 1:3].clamp_(min=NEG_INF)
    # psi = r_nb(0) (+) (+)_{t>=1} phi(t-1) + x_c(t), as the reference's
    # scan accumulates it.
    terms = torch.cat([z[0:1, 1], z[:-1, 0] + x[1:, 0]], dim=0)
    psi = torch.logsumexp(terms, dim=0).clamp(min=NEG_INF)  # [N, P]
    return psi, z[:, 1:3].permute(2, 3, 0, 1)


def final_score(state: CTCPrefixState, lengths: torch.Tensor) -> torch.Tensor:
    """log P_ctc of each prefix as a complete hypothesis: r_b (+) r_nb at
    the last valid frame."""
    n, t, _ = state.r.shape
    idx = torch.clamp(lengths - 1, 0, t - 1).long()
    r_last = state.r[torch.arange(n, device=idx.device), idx]  # [N, 2]
    return torch.logaddexp(r_last[:, 0], r_last[:, 1])


def select(r_new: torch.Tensor, psi_new: torch.Tensor, cand: torch.Tensor,
           parent: torch.Tensor, choice: torch.Tensor) -> CTCPrefixState:
    """The new state of each hypothesis: candidate ``choice[n]`` of old
    hypothesis ``parent[n]`` (the reference gathers the parents' [P, T, 2]
    lattices first; indexing both at once copies only the chosen one)."""
    return CTCPrefixState(r=r_new[parent, choice], psi=psi_new[parent, choice],
                          last=cand[parent, choice])
