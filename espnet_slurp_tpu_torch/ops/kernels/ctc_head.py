"""Fused CTC head (kernel K4): projection + logsumexp + label gather.

Port of espnet_slurp_tpu/ops/pallas/ctc_head.py (``fused_ctc_head_emit``,
``ctc_loss_pallas_head``). emit[b, t, s] = log_softmax(hs @ w.T + b)[b,
t, ext[b, s]] without [B, T, V] logits in device memory; w is [V, D], the
layout of ``nn.Linear``'s weight (the reference takes its transpose). On
CUDA tensors ``fused_ctc_head_emit`` launches the hand-written kernels in
``csrc/ctc_head.cu``, two forward launches and three backward ones in each
dtype. Forward: lse (hs W^T tile by tile over a split of V, folded into a
(max, sum) per row and split; in bf16 on the ``mma.sync`` mainloop, in
fp32 on the fp32 GEMM mainloop) and gather (z from the splits, emit as
fp32 dot products with the gathered rows of W), the splits' pairs through
fp32 [splits, B T, 2] scratch for the length of the call. Backward: rows,
dx, dw (tensor-core GEMMs in bf16, the fp32 mainloop in fp32), the
dlogits (rounded to the dtype) through [B T, V] scratch for the length of
the call. On CPU tensors it runs ``fused_ctc_head_emit_plain``,
the same function in plain PyTorch with autograd.
``fused_ctc_head_emit_bwd_plain`` is the backward at the kernels' rounding
points. No vocabulary padding: gradients come back for the true
[V, D] and [V]. Labels outside [0, V) are clamped into it, by the kernels
and the plain versions alike. A CUDA tensor the kernels do not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ctc import extend_labels, lattice_loss


def _gather_index(ext, bsz, t, v):
    """ext [B, S] as a gather index over [B, T, V], clamped into [0, V) as
    the kernels clamp it."""
    return ext.long().clamp(0, v - 1)[:, None, :].expand(bsz, t, -1)


def fused_ctc_head_emit_plain(hs: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, ext: torch.Tensor
                              ) -> torch.Tensor:
    """Plain PyTorch version: logits in fp32 from the operands as given,
    logsumexp over V, gather at ext. Returns f32 [B, T, S]."""
    logits = hs.float() @ w.float().t() + b.float()
    z = torch.logsumexp(logits, dim=-1, keepdim=True)
    bsz, t, _ = hs.shape
    return logits.gather(2, _gather_index(ext, bsz, t, w.shape[0])) - z


def fused_ctc_head_emit_bwd_plain(hs: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, ext: torch.Tensor,
                                  z: torch.Tensor, g: torch.Tensor):
    """The backward of fused_ctc_head_emit at the kernels' rounding points:
    (dhs in hs.dtype, dW [V, D] in w.dtype, db fp32) for the cotangent g
    [B, T, S] of emit, given the forward's logsumexp z [B, T].

    As espnet_slurp_tpu/ops/pallas/ctc_head.py:_bwd_kernel: dlg =
    scatter_s(g) - exp(lg - z) * sum_s g in fp32 (duplicate labels add),
    rounded to hs.dtype before dhs = dlg W and dW = dlg^T hs (fp32
    products; in fp32 the rounding changes nothing); db summed from the
    unrounded dlg. g is scattered as given:
    the reference rounds it to bf16 first, an artifact of its one-hot
    product (ROADMAP queue 3)."""
    bsz, t, d = hs.shape
    v = w.shape[0]
    gf = g.float()
    dlg = torch.exp(hs.float() @ w.float().t() + b.float() - z[..., None])
    dlg.mul_(-gf.sum(-1, keepdim=True))
    dlg.scatter_add_(2, _gather_index(ext, bsz, t, v), gf)
    dlgc = dlg.to(hs.dtype).float()
    dhs = (dlgc @ w.float()).to(hs.dtype)
    dw = (dlgc.reshape(-1, v).t() @ hs.float().reshape(-1, d)).to(w.dtype)
    return dhs, dw, dlg.sum((0, 1))


def _check(hs, w, b, ext):
    if hs.ndim != 3 or w.ndim != 2 or b.ndim != 1 or ext.ndim != 2:
        raise ValueError("fused_ctc_head_emit: expected hs [B, T, D], "
                         "w [V, D], b [V], ext [B, S]")
    bsz, _, d = hs.shape
    if w.shape[1] != d or b.shape[0] != w.shape[0] or ext.shape[0] != bsz:
        raise ValueError(f"fused_ctc_head_emit: shapes hs {tuple(hs.shape)} "
                         f"w {tuple(w.shape)} b {tuple(b.shape)} ext "
                         f"{tuple(ext.shape)} do not match")
    if hs.dtype not in build.DTYPE_CODES or w.dtype != hs.dtype:
        raise TypeError("fused_ctc_head_emit: hs and w must share float32 "
                        "or bfloat16")
    if b.dtype != torch.float32 or ext.dtype != torch.int32:
        raise TypeError("fused_ctc_head_emit: b must be float32 and ext "
                        "int32")
    if len({x.device for x in (hs, w, b, ext)}) != 1:
        raise ValueError("fused_ctc_head_emit: all arguments must be on one "
                         "device")


def _plan(n, d, v, dtype, dev):
    """The launches' plan from the library for ``dtype``: (V splits of
    lse, splits of N for dw)."""
    out = (ctypes.c_int * 2)()
    build.check(build.library().espnet_ctc_head_plan(
        build.DTYPE_CODES[dtype], n, d, v,
        torch.cuda.get_device_properties(dev).multi_processor_count, out),
        "fused_ctc_head_emit plan")
    return tuple(out)


def _launch_fwd(hs, w, b, ext):
    bsz, t, d = hs.shape
    v, s = w.shape[0], ext.shape[1]
    emit = torch.empty(bsz, t, s, dtype=torch.float32, device=hs.device)
    z = torch.empty(bsz, t, dtype=torch.float32, device=hs.device)
    # lse -> gather: each V split's (max, sum) a row goes through fp32
    # [splits, B T, 2] scratch (freed when the call returns).
    nsplit = _plan(bsz * t, d, v, hs.dtype, hs.device)[0]
    part = torch.empty(nsplit, bsz * t, 2, dtype=torch.float32,
                       device=hs.device)
    build.check(build.library().espnet_ctc_head_fwd(
        build.DTYPE_CODES[hs.dtype], hs.data_ptr(), w.data_ptr(),
        b.data_ptr(), ext.data_ptr(), emit.data_ptr(), z.data_ptr(),
        part.data_ptr(), nsplit, bsz, t, d, v, s, build.stream_ptr(hs)),
        "fused_ctc_head_emit forward")
    fused_ctc_head_emit.launches += 1
    return emit, z


def _launch_bwd(hs, w, b, ext, z, g):
    """-> (dhs, dW [V, D] in w's dtype, db)."""
    bsz, t, d = hs.shape
    v, s = w.shape[0], ext.shape[1]
    n = bsz * t
    dev = hs.device
    dx = torch.empty_like(hs)
    f32 = dict(dtype=torch.float32, device=dev)
    lib = build.library()
    # rows -> dx -> dw: dlogits goes through [B T, VP] scratch in hs's
    # dtype (freed when the call returns); dW is split over N so that its
    # tiles fill the card (the library's plan); db is summed per 128-row
    # tile.
    step = 8 if hs.dtype == torch.bfloat16 else 4  # 16-byte scratch rows
    vp = -(-v // step) * step
    nsplit = _plan(n, d, v, hs.dtype, dev)[1]
    parts = -(-n // lib.espnet_ctc_head_bwd_row_tile())
    dsum = g.sum(-1)
    dlg = torch.empty(n, vp, dtype=hs.dtype, device=dev)
    dw_part = torch.empty(nsplit, v, d, **f32)
    db_part = torch.empty(parts, v, **f32)
    build.check(lib.espnet_ctc_head_bwd(
        build.DTYPE_CODES[hs.dtype], hs.data_ptr(), w.data_ptr(),
        b.data_ptr(), ext.data_ptr(), z.data_ptr(), g.data_ptr(),
        dsum.data_ptr(), dlg.data_ptr(), vp, dx.data_ptr(),
        dw_part.data_ptr(), db_part.data_ptr(), nsplit, bsz, t, d, v, s,
        build.stream_ptr(hs)), "fused_ctc_head_emit backward")
    fused_ctc_head_emit.bwd_launches += 1
    return dx, dw_part.sum(0).to(w.dtype), db_part.sum(0)


class _CtcHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, w, b, ext):
        emit, z = _launch_fwd(hs, w, b, ext)
        ctx.save_for_backward(hs, w, b, ext, z)
        return emit

    @staticmethod
    def backward(ctx, g):
        hs, w, b, ext, z = ctx.saved_tensors
        return (*_launch_bwd(hs, w, b, ext, z, g.float().contiguous()),
                None)


def fused_ctc_head_emit(hs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        ext: torch.Tensor) -> torch.Tensor:
    """emit[b, t, s] = log_softmax(hs @ w.T + b)[b, t, ext[b, s]], f32.

    hs: [B, T, D]; w: [V, D] (``nn.Linear``'s layout; hs and w float32 or
    bfloat16, fp32 accumulation); b: float32 [V]; ext: int32 [B, S] with
    entries in [0, V) (others are clamped into it). Differentiable in hs,
    w and b; on the card the backward recomputes the logits tile by tile
    (dW comes back in w's dtype, as the reference returns it, db in
    fp32)."""
    _check(hs, w, b, ext)
    if hs.device.type == "cpu":
        return fused_ctc_head_emit_plain(hs, w, b, ext)
    if hs.device.type != "cuda":
        raise ValueError(f"fused_ctc_head_emit: unsupported device "
                         f"{hs.device}")
    d = hs.shape[-1]
    if d % 16:
        raise ValueError(f"fused_ctc_head_emit kernel: needs D % 16 == 0, "
                         f"got {d}")
    if min(hs.shape[0], hs.shape[1], ext.shape[1]) == 0:
        raise ValueError("fused_ctc_head_emit kernel: needs B, T, S > 0")
    hs, w = hs.contiguous(), w.contiguous()
    for name, x in (("hs", hs), ("w", w)):
        build.check_aligned(name, x)
    return _CtcHead.apply(hs, w, b.contiguous(), ext.contiguous())


fused_ctc_head_emit.launches = 0
fused_ctc_head_emit.bwd_launches = 0


def ctc_loss_pallas_head(hs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         logit_lengths: torch.Tensor, labels: torch.Tensor,
                         label_lengths: torch.Tensor, blank_id: int = 0
                         ) -> torch.Tensor:
    """Per-example CTC loss [B] from encoder states through the fused head
    (w [V, D]) and the lattice (K4 -> K1): no [B, T, V] logits. Columns at or past
    2 U_b + 1 carry NEG; the loss is zeroed where U > T or the likelihood
    saturated (zero_infinity)."""
    ext, skip, smax, last = extend_labels(labels, label_lengths, blank_id)
    emit = fused_ctc_head_emit(hs, w, b, ext.to(torch.int32))
    return lattice_loss(emit, logit_lengths, label_lengths, skip, smax,
                        last)
