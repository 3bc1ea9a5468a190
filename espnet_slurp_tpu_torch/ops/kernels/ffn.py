"""Fused position-wise feed-forward (kernel K2), forward and backward.

dropout(swish(x W1 + b1)) W2 + b2. Port of
espnet_slurp_tpu/ops/pallas/ffn.py:fused_ffn. On a CUDA tensor the
wrapper is a ``torch.autograd.Function`` that launches the hand-written
kernels in ``csrc/ffn.cu``; the autograd context keeps only the inputs,
and the backward forms the hidden again. In bf16 the forward keeps the
hidden tile, its swish and the output accumulator in registers
(``ffn_fwd::fwd_kernel``, D2 of 32, 64, 128 or 256), and the backward is
three tensor-core GEMM kernels (rows, dx, dW) that pass the rounded hidden
and its gradient through [N, d_ff] scratch for the length of the call. In
fp32 both directions are launches of the register-tiled fp32 GEMM of
``csrc/sgemm.cuh`` (``ffn_f32``: hidden and out forward, rows, dx and dw
backward) with the hidden in fp32 [N, d_ff] scratch for the length of a
call. ``fused_ffn_bwd_plain`` is the backward at the kernels' rounding
points. On a CPU tensor the wrapper runs ``fused_ffn_plain``, the same
function in plain PyTorch, whose gradients are PyTorch's autograd. There is
no other route: a CUDA tensor the kernel does not take raises;
``fused_ffn_takes`` says beforehand whether it takes a shape.

Dropout: every launch that forms the hidden (the bf16 forward, the fp32
forward's ``hidden`` and the backward's ``rows`` in both dtypes) draws the
keep mask of hidden element (n, f) in the kernel from Philox4x32-10
(csrc/philox.cuh) under a seed read from device memory, so the backward
regenerates the forward's mask; the plain versions take the same mask
from ops/kernels/philox.py.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build, philox


def _keep(x, f, seed, dropout_rate, keep):
    """The [..., F] keep mask of the hidden: ``keep`` when given, else the
    kernels' Philox mask of (seed, row, column)."""
    if keep is None:
        keep = philox.keep_mask(seed, dropout_rate, x.numel() // x.shape[-1],
                                f)
    return keep.reshape(*x.shape[:-1], f)


def fused_ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, seed=None, *,
                    dropout_rate: float = 0.0,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(swish(x @ w1 + b1)) @ w2 + b2 in fp32, with the hidden
    rounded to x.dtype before the second product, as the kernel does. At a
    rate above 0 the hidden is scaled by 1 / (1 - rate) where ``keep``
    ([..., F] bool; by default the kernels' mask of ``seed``) holds and
    zeroed elsewhere, before the rounding."""
    h = F.silu(x.float() @ w1.float() + b1.float())
    if dropout_rate > 0.0:
        h = philox.apply_keep(h, _keep(x, h.shape[-1], seed, dropout_rate,
                                       keep), dropout_rate)
    h = h.to(x.dtype)
    return (h.float() @ w2.float() + b2.float()).to(x.dtype)


def _check(x, w1, b1, w2, b2):
    d = x.shape[-1]
    if w1.ndim != 2 or w1.shape[0] != d:
        raise ValueError(f"fused_ffn: w1 {tuple(w1.shape)} does not match "
                         f"x {tuple(x.shape)}")
    f, d2 = w1.shape[1], w2.shape[-1]
    if tuple(w2.shape) != (f, d2) or tuple(b1.shape) != (f,) \
            or tuple(b2.shape) != (d2,):
        raise ValueError("fused_ffn: expected w1 [D, F], b1 [F], w2 [F, D2], "
                         "b2 [D2]")
    if x.dtype not in build.DTYPE_CODES or w1.dtype != x.dtype \
            or w2.dtype != x.dtype:
        raise TypeError("fused_ffn: x, w1, w2 must share float32 or bfloat16")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError("fused_ffn: biases must be float32")
    if len({t.device for t in (x, w1, b1, w2, b2)}) != 1:
        raise ValueError("fused_ffn: all arguments must be on one device")
    if not all(t.is_contiguous() for t in (x, w1, b1, w2, b2)):
        raise ValueError("fused_ffn: all arguments must be contiguous")


def fused_ffn_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, g: torch.Tensor, seed=None, *,
                        dropout_rate: float = 0.0,
                        keep: Optional[torch.Tensor] = None):
    """The backward of fused_ffn at the kernel's rounding points: (dx, dW1,
    db1, dW2, db2) for the output cotangent g [..., D2] (x.dtype).

    As espnet_slurp_tpu/ops/pallas/ffn.py:_bwd_kernel: products in fp32 of
    x.dtype operands; the hidden hd (dropped: scaled by 1 / (1 - rate)
    where kept, else 0) and ds rounded to x.dtype before the products that
    take them, dh = g W2^T masked and scaled the same way before the swish
    derivative; db1 summed from the unrounded ds; dx, dW1 and dW2 returned
    in x.dtype, the bias gradients in fp32. ``seed``, ``dropout_rate`` and
    ``keep`` as in fused_ffn_plain."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, g.shape[-1]).float()
    s = xf @ w1.float() + b1.float()
    sig = torch.sigmoid(s)
    h, dh = s * sig, gf @ w2.float().t()
    if dropout_rate > 0.0:
        k = _keep(xf, s.shape[-1], seed, dropout_rate, keep)
        h = philox.apply_keep(h, k, dropout_rate)
        dh = philox.apply_keep(dh, k, dropout_rate)
    hd = h.to(x.dtype).float()
    ds = dh * (sig * (1.0 + s * (1.0 - sig)))
    ds_c = ds.to(x.dtype).float()
    dx = (ds_c @ w1.float().t()).to(x.dtype).reshape(x.shape)
    return (dx, (xf.t() @ ds_c).to(w1.dtype), ds.sum(0),
            (hd.t() @ gf).to(w2.dtype), gf.sum(0))


# Row splits of the bf16 backward's dW products (per-split fp32 partials,
# summed here): N in at most BF16_DW_SPLITS ranges of at least 512 rows.
# The fp32 path takes the library's plan (espnet_fused_ffn_f32_dw_splits).
BF16_DW_SPLITS = 8
# Output widths the bf16 forward kernel keeps in registers.
BF16_D2 = (32, 64, 128, 256)


def _launch_fwd(x, w1, b1, w2, b2, seed=None, rate=0.0):
    lib = build.library()
    d, f, d2 = x.shape[-1], w1.shape[1], w2.shape[1]
    n = x.numel() // d
    out = torch.empty(*x.shape[:-1], d2, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    nsplit, part = 1, None
    if x.dtype == torch.bfloat16:
        # Few row tiles (the serving shape) split F across blocks; their
        # fp32 partials are summed in order by the kernel's reduction.
        nsplit = lib.espnet_fused_ffn_fwd_splits(n, d, f, d2)
        if nsplit > 1:
            part = torch.empty(nsplit, n, d2, dtype=torch.float32,
                               device=x.device)
    else:
        # fp32: hidden -> out through the [N, F] hidden (freed at return).
        part = torch.empty(n, f, dtype=torch.float32, device=x.device)
    build.check(lib.espnet_fused_ffn_fwd(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), nsplit, n, d, f, d2,
        *philox.launch_args(seed, rate), build.stream_ptr(x)), "fused_ffn")
    fused_ffn.launches += 1
    return out


def _launch_bwd(x, w1, b1, w2, g, seed=None, rate=0.0):
    d, f, d2 = x.shape[-1], w1.shape[1], w2.shape[1]
    n = x.numel() // d
    dev = x.device
    if n == 0:
        return (torch.zeros_like(x), torch.zeros_like(w1),
                torch.zeros_like(b1), torch.zeros_like(w2),
                torch.zeros(d2, device=dev))
    lib = build.library()
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    # rows -> dx -> dw: the hidden hd and ds go through [N, F] scratch in
    # x's dtype (freed when the call returns); db1 is summed per row tile.
    if x.dtype == torch.bfloat16:
        nsplit = max(1, min(BF16_DW_SPLITS, n // 512))
    else:
        nsplit = lib.espnet_fused_ffn_f32_dw_splits(
            n, d, f, d2, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        if nsplit < 0:
            build.check(-nsplit, "fused_ffn backward's dW splits")
    parts = -(-n // lib.espnet_fused_ffn_bwd_row_tile())
    hd = torch.empty(n, f, dtype=x.dtype, device=dev)
    ds = torch.empty(n, f, dtype=x.dtype, device=dev)
    dw1p = torch.empty(nsplit, d, f, **f32)
    db1p = torch.empty(parts, f, **f32)
    dw2p = torch.empty(nsplit, f, d2, **f32)
    db2p = torch.empty(nsplit, d2, **f32)
    build.check(lib.espnet_fused_ffn_bwd(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), g.data_ptr(), dx.data_ptr(),
        hd.data_ptr(), ds.data_ptr(), dw1p.data_ptr(), db1p.data_ptr(),
        dw2p.data_ptr(), db2p.data_ptr(), nsplit, n, d, f, d2,
        *philox.launch_args(seed, rate),
        build.stream_ptr(x)), "fused_ffn backward")
    fused_ffn.bwd_launches += 1
    # dW back in the weights' dtype, as the reference returns them.
    return (dx, dw1p.sum(0).to(w1.dtype), db1p.sum(0),
            dw2p.sum(0).to(w2.dtype), db2p.sum(0))


class _FusedFfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        ctx.save_for_backward(x, w1, b1, w2, seed)
        ctx.rate = rate
        return _launch_fwd(x, w1, b1, w2, b2, seed, rate)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, seed = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        build.check_aligned("g", g)
        return (*_launch_bwd(x, w1, b1, w2, g, seed, ctx.rate), None, None)


def fused_ffn_takes(n: int, d: int, f: int, d2: int,
                    dtype: torch.dtype) -> bool:
    """Whether both directions' launches on the card take N rows of widths
    D, F, D2 in ``dtype`` (the bf16 forward's output widths and shared
    memory, every launch's multiples): the shape route of
    models/conformer.py:FeedForward, asked of the built library."""
    if dtype not in build.DTYPE_CODES:
        return False
    return bool(build.library().espnet_fused_ffn_takes(
        build.DTYPE_CODES[dtype], max(1, n), d, f, d2))


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, seed=None, *,
              dropout_rate: float = 0.0) -> torch.Tensor:
    """dropout(swish(x @ w1 + b1)) @ w2 + b2 without a device-memory hidden.

    x: [..., D]; w1: [D, F]; b1: float32 [F]; w2: [F, D2]; b2: float32 [D2].
    x, w1, w2 are float32 or bfloat16 (fp32 accumulation). Any number of
    rows. Returns [..., D2] in x.dtype, differentiable in every argument
    (on the card through the backward kernels). ``seed`` (int32 [1] on x's
    device; zeros when None, as the reference) and ``dropout_rate`` (in [0,
    1)) keep the reference's signature; every launch takes them, in both
    dtypes.
    """
    rate = float(dropout_rate)
    seed = philox.checked_seed(seed, rate, x.device, "fused_ffn")
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, seed, dropout_rate=rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    d, f, d2 = x.shape[-1], w1.shape[1], w2.shape[1]
    if not fused_ffn_takes(x.numel() // d, d, f, d2, x.dtype):
        raise ValueError(
            f"fused_ffn kernel: does not take D={d} F={f} D2={d2} in "
            f"{x.dtype} (D, D2 % 16 == 0; F % 64 == 0 and D2 in {BF16_D2} "
            "in bf16; F % 32 == 0 in fp32)")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("b1", b1),
                    ("b2", b2)):
        build.check_aligned(name, t)
    return _FusedFfn.apply(x, w1, b1, w2, b2, seed, rate)


fused_ffn.launches = 0
fused_ffn.bwd_launches = 0
