"""Fused Conformer convolution module (kernel K6), forward and backward.

Port of espnet_slurp_tpu/ops/pallas/conv_module.py:fused_conv_module:
pointwise1 [D -> 2D] -> GLU -> prefix pad mask -> depthwise conv (flax SAME
for odd k, or causal) -> LayerNorm (eps 1e-6) -> swish -> pointwise2, every
intermediate in fp32. On a CUDA tensor the wrapper is a
``torch.autograd.Function`` that launches the hand-written kernels in
``csrc/conv_module.cu``, each product formed once over the B T rows, with
g = GLU(pw1(x)), sigmoid(gate), dc and du through scratch that lives for
the call (no [B, T, 2D] hidden kept between forward and backward): in
bfloat16 (``conv_bf16``) two forward launches and six backward ones on the
``mma.sync`` mainloop; in float32 (``conv_f32``) three forward launches and
seven backward ones on the fp32 FMA mainloop of ``csrc/sgemm.cuh``. On a
CPU tensor it runs ``fused_conv_module_plain``, the same fp32-intermediate
composition in plain PyTorch, whose gradients are PyTorch's autograd;
``fused_conv_module_bwd_plain`` is the backward at the reference's
rounding points. A CUDA tensor the kernels do not take (D not a multiple
of 64 or past 512, a halo past the card's shared memory) raises.

Unlike the reference, the weights come in PyTorch's layouts, as the port's
ConvModule holds them (no transpose per call): w1 [2D, D] and w2 [D, D]
(nn.Linear's [out, in]), the depthwise taps [D, k] (Conv1d's [D, 1, k]).
The reference's D % 128 rule is a TPU lane rule; the kernels need
D % 64 == 0, and mask a ragged T themselves.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build


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


def fused_conv_module_bwd_plain(x, lengths, w1, b1, wdw, bdw, gamma, beta,
                                w2, go, *, kernel_size: int,
                                causal: bool = False, eps: float = 1e-6):
    """The backward of fused_conv_module at the reference's rounding points
    (espnet_slurp_tpu/ops/pallas/conv_module.py:_bwd_kernel) in plain
    PyTorch: (dx, dw1, db1, dwdw, dbdw, dgamma, dbeta, dw2, db2) for the
    cotangent go of the output, in the port's layouts, dx in x.dtype and
    dW1 / dW2 in the weights' dtypes.

    Every intermediate is fp32; go and the swish output sw are rounded to
    x.dtype before the products dsw = go W2 and dW2 = go^T sw, and du =
    (da, dgate) is rounded to x.dtype before dx = du W1 and dW1 = du^T x;
    db1 sums the unrounded du."""
    _, t, d = x.shape
    k = kernel_size
    pl = left_pad(k, causal)
    pr = k - 1 - pl
    dt = x.dtype
    xf = x.float()
    u = xf @ w1.float().t() + b1.float()
    a, sig = u[..., :d], torch.sigmoid(u[..., d:])
    m = torch.ones(x.shape[:2], device=x.device) if lengths is None else (
        torch.arange(t, device=x.device)[None, :]
        < lengths.to(x.device)[:, None]).float()
    g = a * sig * m[..., None]
    gp = F.pad(g, (0, 0, pl, pr))
    wf = wdw.float()
    c = bdw.float().expand_as(g)
    for j in range(k):
        c = c + wf[:, j] * gp[:, j:j + t]
    mu = c.mean(-1, keepdim=True)
    rstd = torch.rsqrt((c - mu).square().mean(-1, keepdim=True) + eps)
    chat = (c - mu) * rstd
    nrm = chat * gamma.float() + beta.float()
    sig_n = torch.sigmoid(nrm)
    swc = (nrm * sig_n).to(dt).float()
    goc = go.to(dt).float()
    dw2 = goc.reshape(-1, d).t() @ swc.reshape(-1, d)
    db2 = goc.sum((0, 1))
    dsw = goc @ w2.to(dt).float()
    dn = dsw * (sig_n * (1.0 + nrm * (1.0 - sig_n)))
    dgamma = (dn * chat).sum((0, 1))
    dbeta = dn.sum((0, 1))
    dchat = dn * gamma.float()
    dc = rstd * (dchat - dchat.mean(-1, keepdim=True)
                 - chat * (dchat * chat).mean(-1, keepdim=True))
    dbdw = dc.sum((0, 1))
    dwdw = torch.stack([(dc * gp[:, j:j + t]).sum((0, 1))
                        for j in range(k)], -1)
    dcp = F.pad(dc, (0, 0, pr, pl))
    dg = torch.zeros_like(dc)
    for j in range(k):
        dg = dg + wf[:, j] * dcp[:, k - 1 - j:k - 1 - j + t]
    dg = dg * m[..., None]
    du = torch.cat([dg * sig, dg * a * sig * (1.0 - sig)], -1)
    duc = du.to(dt).float()
    dx = (duc @ w1.to(dt).float()).to(dt)
    dw1 = duc.reshape(-1, 2 * d).t() @ xf.reshape(-1, d)
    return (dx, dw1.to(w1.dtype), du.sum((0, 1)), dwdw, dbdw, dgamma, dbeta,
            dw2.to(w2.dtype), db2)


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


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dw_splits(n: int, d: int, device, dtype=torch.bfloat16) -> int:
    """Splits of N = B T for the backward's dW launch in dtype (the
    library's plan for this card)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = build.library()
    plan = lib.espnet_conv_f32_dw_splits if dtype == torch.float32 \
        else lib.espnet_conv_bf16_dw_splits
    s = plan(n, d, _sms(idx))
    if s < 0:
        build.check(-s, "fused_conv_module plan")
    return s


def info(which: int, d: int, k: int, dtype=torch.bfloat16):
    """(registers, shared bytes, local bytes, blocks per SM) of launch
    ``which`` at width d and k taps: in bf16 0 glu, 1 out, 2 glu_sig, 3
    rows, 4 du, 5 dx, 6 dw, 7 sum; in fp32 0 glu, 1 norm, 2 out, 3
    glu_sig, 4 dsw, 5 rows, 6 du, 7 dx, 8 dw, 9 sum."""
    buf = (ctypes.c_int * 4)()
    lib = build.library()
    entry = lib.espnet_conv_f32_info if dtype == torch.float32 \
        else lib.espnet_conv_bf16_info
    build.check(entry(which, d, k, buf), "fused_conv_module info")
    return tuple(buf)


def _launch_fwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, k, pl,
                eps):
    b, t, d = x.shape
    out = torch.empty_like(x)
    args = (x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            wdw.data_ptr(), bdw.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), w2.data_ptr(), b2.data_ptr())
    # g = mask(GLU(pw1(x))) in fp32 between the launches; in fp32 also the
    # swish output sw between the conv pass and pw2.
    g = torch.empty(b, t, d, dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        code = build.library().espnet_conv_bf16_fwd(
            *args, g.data_ptr(), out.data_ptr(), b, t, d, k, pl, eps,
            build.stream_ptr(x))
    else:
        sw = torch.empty_like(g)
        code = build.library().espnet_conv_f32_fwd(
            *args, g.data_ptr(), sw.data_ptr(), out.data_ptr(), b, t, d, k,
            pl, eps, build.stream_ptr(x))
    build.check(code, "fused_conv_module")
    fused_conv_module.launches += 1
    return out


def _launch_bwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, go, k, pl,
                eps):
    """(dx, dw1, db1, dwdw, dbdw, dgamma, dbeta, dw2, db2) for the
    cotangent go; dW1 and dW2 in the weights' dtype, as the reference
    returns them."""
    lib = build.library()
    b, t, d = x.shape
    bf16 = x.dtype == torch.bfloat16
    tiles = b * -(-t // lib.espnet_conv_rows_tile())
    nsplit = dw_splits(b * t, d, x.device, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    # Scratch for the call: g and sigmoid(gate) from the pw1 launch, dc
    # (rows -> du; in fp32 it holds dsw before), sw (rows -> dW2), du (du
    # -> dx, dW1); sw and du in x's type.
    g, sig, dc = (torch.empty(b, t, d, **f32) for _ in range(3))
    sw = torch.empty_like(x)
    du = torch.empty(b, t, 2 * d, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    # Partials: column sums a row tile (bf16: db2, dgamma, dbeta, dbdw;
    # fp32: dgamma, dbeta, dbdw, with db2 a split of N), the tap gradient
    # and db1 a row tile, dW1 and dW2 a split.
    vecp = torch.empty(tiles, 4 if bf16 else 3, d, **f32)
    dwdwp = torch.empty(tiles, k, d, **f32)
    db1p = torch.empty(tiles, 2 * d, **f32)
    dw1p = torch.empty(nsplit, 2 * d, d, **f32)
    dw2p = torch.empty(nsplit, d, d, **f32)
    # The partials' sums (the library's last launch, in a fixed order).
    vec = torch.empty(4, d, **f32)
    dwdw = torch.empty(d, k, **f32)
    db1 = torch.empty(2 * d, **f32)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    ptrs = [p.data_ptr() for p in (x, lengths, w1, b1, wdw, bdw, gamma, beta,
                                   w2, go, g, sig, dc, sw, du, dx, vecp,
                                   dwdwp, db1p, dw1p, dw2p)]
    sums = [p.data_ptr() for p in (vec, dwdw, db1, dw1, dw2)]
    shape = (b, t, d, k, pl, eps, build.stream_ptr(x))
    if bf16:
        code = lib.espnet_conv_bf16_bwd(*ptrs, nsplit, *sums, *shape)
        db2, dgamma, dbeta, dbdw = vec
    else:
        db2p = torch.empty(nsplit, d, **f32)
        code = lib.espnet_conv_f32_bwd(*ptrs, db2p.data_ptr(), nsplit, *sums,
                                       vec[3].data_ptr(), *shape)
        dgamma, dbeta, dbdw, db2 = vec
    build.check(code, "fused_conv_module backward")
    fused_conv_module.bwd_launches += 1
    return dx, dw1, db1, dwdw, dbdw, dgamma, dbeta, dw2, db2


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
