"""Lattice-style CTC n-best decode with n-best rescoring (the k2 decode's
analogue). Port of espnet_slurp_tpu/decode/lattice.py.

The "lattice" is the frame-synchronous CTC prefix beam
(decode/timesync.py:ctc_prefix_beam_full): its final beam is the n-best
path set with exact CTC path-sum scores. Rescoring composes the attention
decoder's (train/mbr.py:hyp_scores), a neural LM's (``lm_seq_scores``), an
ARPA n-gram's (``ngram_seq_scores``, through decode/ngram.py:
make_ngram_fusion's step) and a length bonus over those paths, batched,
and takes the argmax. As in the reference, the prefix beam keeps K paths
where a k2 lattice can hold exponentially many; the reference's n-best
extraction also keeps K before it rescores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .timesync import TimeSyncConfig, ctc_prefix_beam_full, pick_best


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    beam_size: int = 10       # lattice beam = n-best paths retained
    pre_beam_size: int = 8
    max_len: int = 128
    att_weight: float = 0.0   # decoder rescoring (am_scores analogue)
    lm_weight: float = 0.0    # neural LM rescoring (lm_scores analogue)
    ngram_weight: float = 0.0  # ARPA n-gram rescoring
    length_bonus: float = 0.0


@torch.inference_mode()
def lm_seq_scores(lm_model, tokens: torch.Tensor, lengths: torch.Tensor,
                  sos_id: int, eos_id: int) -> torch.Tensor:
    """The teacher-forced whole-sequence LM log-prob, eos included: tokens
    [B, K, L], lengths [B, K] -> [B, K] fp32. ``lm_model`` is a
    models/lm.py LM (its forward: [N, L] ids, lengths -> logits)."""
    b, k, l = tokens.shape
    n = b * k
    ys = tokens.reshape(n, l).clamp_min(0).long()
    ln = lengths.reshape(n).to(ys.device)
    ys_in = torch.cat([torch.full((n, 1), sos_id, dtype=torch.long,
                                  device=ys.device), ys], dim=1)
    logp = torch.log_softmax(lm_model(ys_in, ln + 1).float(), dim=-1)
    # the target at position j is ys[j] for j < len, eos at j == len
    pos = torch.arange(l + 1, device=ys.device)[None, :]
    tgt = torch.cat([ys, torch.zeros_like(ys[:, :1])], dim=1)
    tgt = torch.where(pos == ln[:, None], eos_id, tgt)
    tok_lp = logp.gather(-1, tgt[..., None])[..., 0]
    return torch.where(pos <= ln[:, None], tok_lp,
                       torch.zeros_like(tok_lp)).sum(dim=1).reshape(b, k)


@torch.inference_mode()
def ngram_seq_scores(ngram_step_init: Tuple[Callable, Callable],
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     sos_id: int) -> torch.Tensor:
    """The n-gram's whole-sequence score through its stepwise fusion
    scorer (decode/ngram.py:make_ngram_fusion; no eos term, as the
    reference's): tokens [B, K, L] -> [B, K] fp32."""
    step, init = ngram_step_init
    b, k, l = tokens.shape
    n = b * k
    ys = tokens.reshape(n, l).clamp_min(0).long()
    ln = lengths.reshape(n).to(ys.device)
    state = init(n)
    y_prev = torch.full((n,), sos_id, dtype=torch.long, device=ys.device)
    total = torch.zeros(n, device=ys.device)
    for j in range(l):
        row, state = step(y_prev, state)  # [N, V] log-probs
        tok = ys[:, j]
        lp = row.gather(1, tok[:, None])[:, 0].float()
        total = total + torch.where(j < ln, lp, torch.zeros_like(lp))
        y_prev = tok
    return total.reshape(b, k)


@torch.inference_mode()
def lattice_rescore_decode(
    model, hs: torch.Tensor, h_lengths: torch.Tensor, cfg: LatticeConfig,
    *, lm_model=None,
    ngram_step_init: Optional[Tuple[Callable, Callable]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """CTC n-best lattice decode with composed rescoring: (tokens [B,
    max_len], lengths [B], details), details holding each path's score
    components ([B, K]: ctc, and att / lm / ngram where they apply, and
    total). The LM and n-gram terms need their model and their weight
    above 0."""
    mcfg = model.cfg
    tokens, lengths, ctc_scores = ctc_prefix_beam_full(
        model, hs, h_lengths,
        TimeSyncConfig(beam_size=cfg.beam_size,
                       pre_beam_size=cfg.pre_beam_size, max_len=cfg.max_len))
    total = ctc_scores
    details = {"ctc": ctc_scores}
    if cfg.att_weight > 0.0:
        from ..train.mbr import hyp_scores
        att = hyp_scores(model, hs, h_lengths, tokens, lengths)
        details["att"] = att
        total = (1.0 - cfg.att_weight) * total + cfg.att_weight * att
    if cfg.lm_weight > 0.0 and lm_model is not None:
        lm = lm_seq_scores(lm_model, tokens, lengths, mcfg.sos_id,
                           mcfg.eos_id)
        details["lm"] = lm
        total = total + cfg.lm_weight * lm
    if cfg.ngram_weight > 0.0 and ngram_step_init is not None:
        ng = ngram_seq_scores(ngram_step_init, tokens, lengths, mcfg.sos_id)
        details["ngram"] = ng
        total = total + cfg.ngram_weight * ng
    if cfg.length_bonus != 0.0:
        total = total + cfg.length_bonus * lengths.float()
    details["total"] = total
    out, out_len = pick_best(tokens, lengths, total)
    return out, out_len, details
