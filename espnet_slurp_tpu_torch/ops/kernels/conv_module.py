"""Fused Conformer convolution module (kernel K6), forward and backward.

Port of espnet_slurp_tpu/ops/pallas/conv_module.py:fused_conv_module:
pointwise1 [D -> 2D] -> GLU -> prefix pad mask -> depthwise conv (flax SAME
for odd k, or causal) -> LayerNorm (eps 1e-6) -> swish -> pointwise2, every
intermediate in fp32. On a CUDA tensor the wrapper is a
``torch.autograd.Function`` that launches the hand-written kernels in
``csrc/conv_module.cu`` (no [B, T, 2D] hidden in device memory, either
way); on a CPU tensor it runs ``fused_conv_module_plain``, the same
fp32-intermediate composition in plain PyTorch, whose gradients are
PyTorch's autograd. A CUDA tensor the kernel does not take raises.

Unlike the reference, the weights come in PyTorch's layouts, as the port's
ConvModule holds them (no transpose per call): w1 [2D, D] and w2 [D, D]
(nn.Linear's [out, in]), the depthwise taps [D, k] (Conv1d's [D, 1, k]).
The reference's D % 128 rule is a TPU lane rule; the kernel needs
D % 64 == 0, and masks a ragged T itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

# Row splits of the dW1 / dW2 reductions (per-split fp32 partials).
DW_SPLITS = 16


def left_pad(kernel_size: int, causal: bool) -> int:
    """Frames the depthwise conv pads on the left: k - 1 causal, (k - 1) / 2
    for flax's SAME with an odd k."""
    return kernel_size - 1 if causal else (kernel_size - 1) // 2


def fused_conv_module_plain(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2,
                            b2, *, kernel_size: int, causal: bool = False,
                            eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_forward_core`` + pointwise2 in plain PyTorch: the
    products take x's values with fp32 accumulation, every intermediate is
    fp32, the swish output is rounded to x.dtype before pointwise2."""
    _, t, d = x.shape
    k = kernel_size
    pl = left_pad(k, causal)
    u = x.float() @ w1.float().t() + b1.float()
    g = u[..., :d] * torch.sigmoid(u[..., d:])
    if lengths is not None:
        m = torch.arange(t, device=x.device)[None, :] < lengths.to(
            x.device)[:, None]
        g = g * m[..., None]
    gp = F.pad(g, (0, 0, pl, k - 1 - pl))
    wf = wdw.float()
    c = bdw.float().expand_as(g)
    for j in range(k):
        c = c + wf[:, j] * gp[:, j:j + t]
    mu = c.mean(-1, keepdim=True)
    var = (c - mu).square().mean(-1, keepdim=True)
    nrm = (c - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    sw = (nrm * torch.sigmoid(nrm)).to(x.dtype)
    return (sw.float() @ w2.float().t() + b2.float()).to(x.dtype)


def _check(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, k, causal):
    if x.ndim != 3:
        raise ValueError("fused_conv_module: x must be [B, T, D]")
    b, _, d = x.shape
    if not causal and k % 2 == 0:
        raise ValueError("fused_conv_module: SAME padding needs an odd "
                         "kernel_size")
    shapes = {"w1": (w1, (2 * d, d)), "b1": (b1, (2 * d,)),
              "wdw": (wdw, (d, k)), "bdw": (bdw, (d,)),
              "gamma": (gamma, (d,)), "beta": (beta, (d,)),
              "w2": (w2, (d, d)), "b2": (b2, (d,))}
    for name, (p, shape) in shapes.items():
        if tuple(p.shape) != shape:
            raise ValueError(f"fused_conv_module: {name} {tuple(p.shape)} != "
                             f"{shape}")
    if x.dtype not in build.DTYPE_CODES or w1.dtype != x.dtype \
            or w2.dtype != x.dtype:
        raise TypeError("fused_conv_module: x, w1, w2 must share float32 or "
                        "bfloat16")
    if any(p.dtype != torch.float32 for p in (b1, wdw, bdw, gamma, beta, b2)):
        raise TypeError("fused_conv_module: biases, taps and LayerNorm "
                        "parameters must be float32")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError("fused_conv_module: lengths must be [B]")
    args = (x, w1, b1, wdw, bdw, gamma, beta, w2, b2)
    if len({p.device for p in args}) != 1:
        raise ValueError("fused_conv_module: all arguments must be on one "
                         "device")


def _launch_fwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, k, pl,
                eps):
    b, t, d = x.shape
    out = torch.empty_like(x)
    build.check(build.library().espnet_conv_module_fwd(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), lengths.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), b, t, d, k, pl, eps, build.stream_ptr(x)),
        "fused_conv_module")
    fused_conv_module.launches += 1
    return out


def _launch_bwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, g, k, pl,
                eps):
    """(dx, dw1, db1, dwdw, dbdw, dgamma, dbeta, dw2, db2); dW1 and dW2 in
    the weights' dtype, as the reference returns them."""
    lib = build.library()
    code = build.DTYPE_CODES[x.dtype]
    b, t, d = x.shape
    rows_tile = lib.espnet_conv_module_rows_tile(code)
    nblk = b * -(-t // rows_tile)
    nsplit = max(1, min(DW_SPLITS, nblk))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dc = torch.empty(b, t, d, **f32)
    sw = torch.empty_like(x)
    vecp = torch.empty(nblk, 4, d, **f32)
    dw1p = torch.empty(nsplit, 2 * d, d, **f32)
    db1p = torch.empty(nsplit, 2 * d, **f32)
    dwdwp = torch.empty(nsplit, d, k, **f32)
    dw2p = torch.empty(nsplit, d, d, **f32)
    build.check(lib.espnet_conv_module_bwd(
        code, x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        wdw.data_ptr(), bdw.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), dc.data_ptr(),
        sw.data_ptr(), vecp.data_ptr(), dw1p.data_ptr(), db1p.data_ptr(),
        dwdwp.data_ptr(), dw2p.data_ptr(), nsplit, b, t, d, k, pl, eps,
        build.stream_ptr(x)), "fused_conv_module backward")
    fused_conv_module.bwd_launches += 1
    db2, dgamma, dbeta, dbdw = vecp.sum(0)
    return (dx, dw1p.sum(0).to(w1.dtype), db1p.sum(0), dwdwp.sum(0), dbdw,
            dgamma, dbeta, dw2p.sum(0).to(w2.dtype), db2)


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, k,
                pl, eps):
        ctx.save_for_backward(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2)
        ctx.conv = (k, pl, eps)
        return _launch_fwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2,
                           k, pl, eps)

    @staticmethod
    def backward(ctx, g):
        x, lengths, *params = ctx.saved_tensors
        grads = _launch_bwd(x, lengths, *params, g.to(x.dtype).contiguous(),
                            *ctx.conv)
        return (grads[0], None, *grads[1:], None, None, None)


def fused_conv_module(x: torch.Tensor, lengths, w1: torch.Tensor,
                      b1: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, *,
                      kernel_size: int, causal: bool = False,
                      eps: float = 1e-6) -> torch.Tensor:
    """Fused conformer conv module: x [B, T, D] -> [B, T, D] in x.dtype.

    lengths: [B] valid frames (None: all T). w1 [2D, D], w2 [D, D] in
    x.dtype (float32 or bfloat16); b1 [2D], wdw [D, k], bdw, gamma, beta,
    b2 [D] float32. kernel_size odd unless ``causal``. Differentiable in x
    and every parameter (on the card through the backward kernels)."""
    k = int(kernel_size)
    _check(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, k, causal)
    if x.device.type == "cpu":
        return fused_conv_module_plain(x, lengths, w1, b1, wdw, bdw, gamma,
                                       beta, w2, b2, kernel_size=k,
                                       causal=causal, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_module: unsupported device {x.device}")
    b, t, d = x.shape
    if d % 64 or b == 0 or t == 0:
        raise ValueError(f"fused_conv_module kernel: needs D % 64 == 0 and "
                         f"B, T > 0, got {tuple(x.shape)}")
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    args = [p.contiguous() for p in (x, lengths.to(x.device, torch.int32),
                                     w1, b1, wdw, bdw, gamma, beta, w2, b2)]
    for name, p in zip(("x", "w1", "w2"), (args[0], args[2], args[8])):
        build.check_aligned(name, p)
    return _FusedConv.apply(*args, k, left_pad(k, causal), float(eps))


fused_conv_module.launches = 0
fused_conv_module.bwd_launches = 0
