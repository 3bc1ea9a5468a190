"""RNN-T (transducer) loss. Port of espnet_slurp_tpu/ops/transducer.py.

``rnnt_loss_from_logprobs`` gathers the blank and emit tables from the
joint's [B, T, U+1, V] log-probs and runs the lattice, kernel K5
(ops/kernels/transducer.py:rnnt_lattice; its plain version on CPU tensors),
where the reference takes its Pallas kernel on a TPU and its anti-diagonal
scan elsewhere. Rows with U_b > U or T_b < 1 give loss 0 and gradient 0
(the reference's ``feasible`` mask, :69-70).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.transducer import NEG, rnnt_lattice


def rnnt_loss_from_logprobs(log_probs: torch.Tensor, labels: torch.Tensor,
                            logit_lengths: torch.Tensor,
                            label_lengths: torch.Tensor,
                            blank_id: int = 0) -> torch.Tensor:
    """Per-example negative log-likelihood [B] (fp32).

    log_probs: [B, T, U+1, V]; labels: [B, U] target ids (entries past each
    row's length are ignored: paths never move down in u, so the emit table
    at u >= U_b cannot reach the final node); logit_lengths: [B] valid
    frames T_b; label_lengths: [B] valid labels U_b."""
    b, t, u1, v = log_probs.shape
    u = u1 - 1
    blank = log_probs[..., blank_id].float()
    lbl = labels.long().clamp(0, v - 1)
    emit = log_probs[:, :, :u, :].gather(
        3, lbl[:, None, :, None].expand(b, t, u, 1))[..., 0].float()
    emit = F.pad(emit, (0, 1), value=NEG)
    tl = logit_lengths.to(log_probs.device)
    ul = label_lengths.to(log_probs.device)
    loss = rnnt_lattice(blank.contiguous(), emit.contiguous(),
                        tl.to(torch.int32), ul.to(torch.int32))
    feasible = (ul <= u) & (tl >= 1)
    return torch.where(feasible, loss, torch.zeros_like(loss))


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor,
              logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
              blank_id: int = 0) -> torch.Tensor:
    """logits: [B, T, U+1, V] raw joint outputs -> per-example NLL [B]."""
    return rnnt_loss_from_logprobs(
        torch.log_softmax(logits.float(), dim=-1), labels, logit_lengths,
        label_lengths, blank_id)


def rnnt_loss_mean(logits, labels, logit_lengths, label_lengths,
                   blank_id: int = 0) -> torch.Tensor:
    """Batch-size-normalised RNN-T loss (sum / B)."""
    per = rnnt_loss(logits, labels, logit_lengths, label_lengths, blank_id)
    return per.sum() / per.shape[0]
