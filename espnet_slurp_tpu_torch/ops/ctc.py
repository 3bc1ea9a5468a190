"""CTC loss. Port of espnet_slurp_tpu/ops/ctc.py.

The lattice under every entry point is kernel K1
(ops/kernels/ctc.py:ctc_lattice; on CPU tensors its plain version).
``_fused_emit`` gathers the label emissions straight from the logits with
a per-frame logsumexp, and its backward recomputes the softmax from the
saved logits, so no fp32 [B, T, V] log-probs are kept for the backward.
zero_infinity: rows with U > T, or whose likelihood saturated at NEG
(T < U + adjacent repeats), give loss 0 and gradient 0
(espnet_slurp_tpu/ops/ctc.py:151-156). ``collapse_repeats`` is the
reference's host-side best-path collapse.
"""
from __future__ import annotations

import torch

from .kernels.ctc import extend_labels, lattice_loss


class _FusedEmit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, ext):
        z = torch.logsumexp(logits.float(), dim=-1)  # [B, T]
        b, t, _ = logits.shape
        idx = ext[:, None, :].expand(b, t, -1)
        ctx.save_for_backward(logits, z, idx)
        return logits.gather(2, idx).float() - z[..., None]

    @staticmethod
    def backward(ctx, de):
        logits, z, idx = ctx.saved_tensors
        soft = torch.exp(logits.float() - z[..., None])
        dlg = -soft * de.sum(-1, keepdim=True)
        dlg.scatter_add_(2, idx, de.float())
        return dlg.to(logits.dtype), None


def _fused_emit(logits: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """emit[b, t, s] = log_softmax(logits)[b, t, ext[b, s]] (fp32)."""
    return _FusedEmit.apply(logits, ext)


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-example negative log-likelihood [B] from log-probs [B, T, V]."""
    ext, skip, smax, last = extend_labels(labels, label_lengths, blank_id)
    b, t, _ = log_probs.shape
    emit = log_probs.gather(2, ext[:, None, :].expand(b, t, -1)).float()
    return lattice_loss(emit, logit_lengths, label_lengths, skip, smax, last)


def ctc_loss_logits(logits: torch.Tensor, logit_lengths: torch.Tensor,
                    labels: torch.Tensor, label_lengths: torch.Tensor,
                    blank_id: int = 0) -> torch.Tensor:
    """Per-example CTC loss [B] straight from projection logits."""
    ext, skip, smax, last = extend_labels(labels, label_lengths, blank_id)
    return lattice_loss(_fused_emit(logits, ext), logit_lengths,
                        label_lengths, skip, smax, last)


def ctc_loss_mean_logits(logits, logit_lengths, labels, label_lengths,
                         blank_id: int = 0) -> torch.Tensor:
    """Batch-size-normalised CTC loss from logits (sum / B)."""
    per = ctc_loss_logits(logits, logit_lengths, labels, label_lengths,
                          blank_id)
    return per.sum() / per.shape[0]


def collapse_repeats(ids, blank_id: int = 0):
    """Host-side best-path collapse of a frame-id sequence: repeats merged,
    blanks dropped."""
    out = []
    prev = None
    for i in ids:
        i = int(i)
        if i != blank_id and i != prev:
            out.append(i)
        prev = i
    return out
