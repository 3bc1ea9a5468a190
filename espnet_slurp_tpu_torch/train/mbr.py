"""MBR / KB-MBR training: minimum expected word-piece error over an n-best.

Port of espnet_slurp_tpu/train/mbr.py (the fork's e2e_asr.py
get_mbr_loss / get_KBmbr_loss fed by batch_decode_nbest):

- the n-best of the current model comes from decode/beam.py's search,
  under ``torch.no_grad`` on detached encoder states (no gradient through
  the search);
- each hypothesis is scored by the teacher-forced decoder log-prob, which
  carries the gradient (``hyp_scores``);
- its risk is the word-piece edit distance to the reference
  (``edit_distance``), the ground truth joining as hypothesis 0 at risk 0
  (``include_gt``);
- the loss is E_p[risk - mean risk] per utterance, batch-averaged, and
  KB-MBR adds ``rare_weight`` x E_p[rare risk], the edit distance between
  the KB-token subsequences (``compact_masked``) of hypothesis and
  reference, over utterances whose reference holds a KB token.

``make_mbr_aux_loss`` gives train/state.py:make_train_step the term: it
re-encodes the batch (no SpecAug, no dropout) and scales the loss by
``weight``. None of this is a kernel in the reference; the encode and the
rescore run the ported kernels as any forward does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.asr_model import IGNORE_ID, add_sos_eos


@dataclasses.dataclass(frozen=True)
class MBRConfig:
    weight: float = 0.0  # 0 disables MBR
    beam_size: int = 4
    pre_beam_size: int = 12
    max_len: int = 96
    ctc_weight: float = 0.0  # CTC weight inside the n-best search
    mwe_factor: float = 1.0  # the fork's mwe_factor
    include_gt: bool = True  # the ground truth as an extra hypothesis
    rare_weight: float = 0.0  # > 0 enables the KB-MBR rare-error term
    # KB token ids of the rare-error term (the subword ids of the biasing
    # list's words).
    kb_tokens: tuple = ()


def edit_distance(hyp: torch.Tensor, hyp_len: torch.Tensor,
                  ref: torch.Tensor, ref_len: torch.Tensor) -> torch.Tensor:
    """Batched Levenshtein distance: hyp [N, Lh], ref [N, Lr] -> [N] long.

    One DP row a hypothesis position, vectorised over N and the reference
    axis: cand[j] = min(prev[j] + 1, prev[j-1] + sub), and the insertion
    chain new[j] = min(cand[j], new[j-1] + 1) is j + cummin_k<=j (cand[k] -
    k). Rows past a hypothesis' length stay frozen; the answer is read at
    each reference's length."""
    n, lh = hyp.shape
    lr = ref.shape[1]
    idx = torch.arange(lr + 1, device=hyp.device)
    hl = hyp_len.to(hyp.device).long()
    rl = ref_len.to(hyp.device).long()
    row = torch.minimum(idx.expand(n, lr + 1), rl[:, None])
    for i in range(lh):
        sub = (ref != hyp[:, i:i + 1]).long()               # [N, Lr]
        cand = torch.cat([row[:, :1] + 1,
                          torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)],
                         dim=1)
        new = torch.cummin(cand - idx, dim=1).values + idx
        row = torch.where((i < hl)[:, None], new, row)
    return row.gather(1, rl[:, None])[:, 0]


def compact_masked(tokens: torch.Tensor, lengths: torch.Tensor,
                   keep_tok: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tokens with keep_tok[token] inside each row's length, moved to
    the front in order: (tokens [N, L], lengths [N])."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    keep = keep_tok[tokens] & (pos < lengths.to(tokens.device)[:, None])
    order = torch.sort((~keep).long(), dim=1, stable=True).indices
    return tokens.gather(1, order), keep.sum(dim=1)


def hyp_scores(model, hs: torch.Tensor, h_lengths: torch.Tensor,
               tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder log-prob of each hypothesis: tokens [B,
    K, L] (no sos / eos), lengths [B, K] -> scores [B, K] fp32 (the fork's
    per-hypothesis ``vscore``, here with its gradient)."""
    c = model.cfg
    b, k, l = tokens.shape
    ys = tokens.reshape(b * k, l).clamp_min(0)
    ln = lengths.reshape(b * k)
    ys_in, ys_out = add_sos_eos(ys, ln, c.sos_id, c.eos_id)
    logits = model.decoder(ys_in, ln + 1, hs.repeat_interleave(k, dim=0),
                           h_lengths.repeat_interleave(k))
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(-1, ys_out.clamp_min(0)[..., None])[..., 0]
    valid = ys_out != IGNORE_ID
    return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(
        dim=1).reshape(b, k)


def _gt_zero(x: torch.Tensor) -> torch.Tensor:
    """x [B, K] with column 0 (the ground truth) set to 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:]], dim=1)


def mbr_loss(model, hs: torch.Tensor, h_lengths: torch.Tensor,
             text: torch.Tensor, text_lengths: torch.Tensor, cfg: MBRConfig,
             *, kb_token_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expected-risk loss over the current model's n-best: (loss, stats)
    with mbr_expected_risk, loss_mbr and, with the rare term,
    mbr_rare_risk. ``hs`` may carry gradient; the search sees it
    detached, the rescore does not."""
    from ..decode.beam import BeamSearchConfig, batch_beam_search
    bcfg = BeamSearchConfig(beam_size=cfg.beam_size,
                            pre_beam_size=cfg.pre_beam_size,
                            max_len=cfg.max_len, ctc_weight=cfg.ctc_weight)
    with torch.no_grad():
        _, _, nb_tokens, nb_lengths, _ = batch_beam_search(
            model, hs.detach(), h_lengths, bcfg, return_nbest=True)
    # clones: the search's results are inference tensors, which autograd
    # cannot save for the rescore's backward
    nb_tokens, nb_lengths = nb_tokens.clone(), nb_lengths.clone()
    b, k, l = nb_tokens.shape
    text_lengths = text_lengths.to(hs.device).long()
    ref = text.to(hs.device).long().clamp_min(0)
    if cfg.include_gt:
        lr = max(l, ref.shape[1])
        gt = F.pad(ref, (0, lr - ref.shape[1]))[:, None, :]
        nb_tokens = torch.cat([gt, F.pad(nb_tokens, (0, lr - l))], dim=1)
        nb_lengths = torch.cat([text_lengths[:, None], nb_lengths], dim=1)
        k, l = k + 1, lr
    p = torch.softmax(hyp_scores(model, hs, h_lengths, nb_tokens,
                                 nb_lengths), dim=-1)
    flat_t = nb_tokens.reshape(b * k, l)
    flat_l = nb_lengths.reshape(b * k)
    ref_rep = ref.repeat_interleave(k, dim=0)
    ref_len_rep = text_lengths.repeat_interleave(k)
    werr = edit_distance(flat_t, flat_l, ref_rep,
                         ref_len_rep).reshape(b, k).float()
    if cfg.include_gt:
        werr = _gt_zero(werr)
    werr = werr * cfg.mwe_factor
    loss = (p * (werr - werr.mean(dim=1, keepdim=True))).sum(dim=1).mean()
    stats = {"mbr_expected_risk": (p * werr).sum(dim=1).mean()}
    if cfg.rare_weight > 0.0 and kb_token_mask is not None:
        mask = kb_token_mask.to(hs.device)
        hyp_rare, hyp_rare_len = compact_masked(flat_t, flat_l, mask)
        ref_rare, ref_rare_len = compact_masked(ref_rep, ref_len_rep, mask)
        rerr = edit_distance(hyp_rare, hyp_rare_len, ref_rare,
                             ref_rare_len).reshape(b, k).float()
        if cfg.include_gt:
            rerr = _gt_zero(rerr)
        # only utterances whose reference holds a KB token count (the
        # fork's rare_seq_ref != [])
        has_rare = (ref_rare_len.reshape(b, k)[:, 0] > 0).float()
        rare_term = (p * rerr).sum(dim=1) * has_rare
        loss = loss + cfg.rare_weight * rare_term.mean()
        stats["mbr_rare_risk"] = rare_term.mean()
    stats["loss_mbr"] = loss
    return loss, stats


def make_mbr_aux_loss(model, cfg: MBRConfig, *, mvn_stats=None,
                      kb_token_mask: Optional[torch.Tensor] = None
                      ) -> Callable:
    """The ``aux_loss_fn`` of train/state.py:make_train_step: batch ->
    (cfg.weight x mbr_loss, its stats). It re-encodes the batch with
    ``train=False`` (no SpecAug, no dropout), as the reference does."""
    def fn(batch):
        hs, h_lengths = model.encode(batch["speech"], batch["speech_lengths"],
                                     mvn_stats)
        loss, stats = mbr_loss(model, hs, h_lengths, batch["text"],
                               batch["text_lengths"], cfg,
                               kb_token_mask=kb_token_mask)
        return cfg.weight * loss, stats
    return fn
