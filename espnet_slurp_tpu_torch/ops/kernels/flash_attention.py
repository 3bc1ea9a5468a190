"""Relative-position flash attention (kernel K3), forward and backward.

Port of espnet_slurp_tpu/ops/pallas/flash_attention.py:rel_flash_attention.
On CUDA tensors ``rel_flash_attention_fwd`` is a ``torch.autograd.Function``
that launches the hand-written kernels in ``csrc/flash_attention.cu``: the
forward (online softmax over key tiles; the rel-shift is a skewed read of
the [H, 2T, Dh] position table; key-length and chunk masks built in the
kernel; no [T, T] or [T, 2T-1] buffer in device memory; in bf16 at Dh 32
and 64 with q, S, P and O in registers, in fp32 at Dh 32, 64 and 128 on
register micro-tiles of exact fp32 FMAs) and the backward (dq_u / dq_v
and dk / dv / dp kernels, dp summed over the batch). On CPU
tensors it runs ``rel_flash_attention_plain``, the same function in plain
PyTorch, whose gradients are PyTorch's autograd. A CUDA tensor the kernel
does not take raises; a head width that is not a multiple of 16 runs
zero-padded to the next width of a redesigned route (``kernel_head_width``,
``pad_heads``: Dh 36 at 64). ``rel_flash_attention_fwd_tiled_plain`` and
``rel_flash_attention_bwd_plain`` are the forward and the backward at the
kernels' rounding points.

Dropout on the probabilities: every launch (the three bf16 and the three
fp32 launches at their Dh, and the WMMA launches of the other Dh) draws the
keep mask of (b * H + h, query, key) in the kernel from Philox4x32-10
(csrc/philox.cuh) under a seed read from device memory, so the backward
regenerates the forward's mask; the forward drops P after adding it into
the softmax's normaliser, so lse is the undropped one. The plain versions
take the same mask from ops/kernels/philox.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, philox

NEG = -1e30
# Key tile of the bf16 forward kernel at Dh 32 and 64
# (csrc/flash_attention.cu: rel_fwd::BK); its online softmax rounds at
# these tile edges.
FWD_BLOCK_K = 64


def allowed_mask(t: int, lengths: torch.Tensor, chunk_size: int = 0,
                 left_chunks: int = -1) -> torch.Tensor:
    """[B, 1, T, T] bool: key j is visible to query i (the kernel's mask)."""
    ar = torch.arange(t, device=lengths.device)
    ok = (ar[None, :] < lengths[:, None])[:, None, None, :]
    if chunk_size > 0:
        rc = (ar // chunk_size)[:, None]
        cc = (ar // chunk_size)[None, :]
        cm = cc <= rc
        if left_chunks >= 0:
            cm = cm & (cc >= rc - left_chunks)
        ok = ok & cm[None, None]
    return ok


def rel_shift_index(t: int, device) -> torch.Tensor:
    """[T, T] column index into the [T, 2T-1] position scores:
    (T-1) - i + j, the Transformer-XL rel-shift as a gather."""
    ar = torch.arange(t, device=device)
    return (t - 1) - ar[:, None] + ar[None, :]


def dropout_keep(seed, dropout_rate: float, b: int, h: int, t: int,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, T, T] keep mask of the probabilities: ``keep`` when given,
    else the kernels' Philox mask of (seed, b * H + h, query, key)."""
    if keep is None:
        keep = philox.keep_mask(seed, dropout_rate, t, t, planes=b * h)
    return keep.reshape(b, h, t, t)


def rel_flash_attention_plain(q_u, q_v, k, v, p, lengths, seed=None, *,
                              scale: float, dropout_rate: float = 0.0,
                              keep: Optional[torch.Tensor] = None,
                              chunk_size: int = 0, left_chunks: int = -1
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out [B,H,T,Dh], lse [B,H,T]).

    Scores and softmax in fp32; at a rate above 0 the probabilities are
    scaled by 1 / (1 - rate) where ``keep`` ([B, H, T, T] bool; by default
    the kernels' mask of ``seed``) holds and zeroed elsewhere (lse stays
    the undropped one); they are rounded to v.dtype before the value
    product, as the kernel does."""
    b, h, t, dh = q_u.shape
    ac = q_u.float() @ k.float().transpose(-1, -2)
    raw = q_v.float() @ p[:, : 2 * t - 1].float().transpose(-1, -2)
    bd = raw.gather(-1, rel_shift_index(t, raw.device).expand(b, h, t, t))
    s = (ac + bd) * scale
    s = s.masked_fill(~allowed_mask(t, lengths, chunk_size, left_chunks), NEG)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        probs = philox.apply_keep(
            probs, dropout_keep(seed, dropout_rate, b, h, t, keep),
            dropout_rate)
    probs = probs.to(v.dtype)
    return (probs.float() @ v.float()).to(q_u.dtype), lse


def rel_flash_attention_fwd_tiled_plain(q_u, q_v, k, v, p, lengths,
                                        seed=None, *, scale: float,
                                        dropout_rate: float = 0.0,
                                        keep: Optional[torch.Tensor] = None,
                                        chunk_size: int = 0,
                                        left_chunks: int = -1,
                                        block_k: int = FWD_BLOCK_K
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward at the kernels' rounding points: (out, lse fp32).

    As espnet_slurp_tpu/ops/pallas/flash_attention.py:_fwd_kernel: scores
    in fp32 from q_u.dtype operands, masked scores NEG, then an online
    softmax over key tiles of ``block_k`` (the running max starts at NEG;
    key columns past T are no part of any tile) with exp(s - m_running)
    added into l, then dropped as in rel_flash_attention_plain, and
    rounded to v.dtype before P v, and l and the output accumulator in
    fp32. Nothing on the main path calls it."""
    b, h, t, dh = q_u.shape
    qu, qv, kf, vf, pf = (x.float() for x in (q_u, q_v, k, v, p))
    bd = (qv @ pf[:, : 2 * t - 1].transpose(-1, -2)).gather(
        -1, rel_shift_index(t, q_u.device).expand(b, h, t, t))
    s = (qu @ kf.transpose(-1, -2) + bd) * scale
    s = s.masked_fill(~allowed_mask(t, lengths, chunk_size, left_chunks), NEG)
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, dropout_rate, b, h, t, keep)
    m = torch.full((b, h, t, 1), NEG, device=q_u.device)
    l = torch.zeros(b, h, t, 1, device=q_u.device)
    acc = torch.zeros(b, h, t, dh, device=q_u.device)
    for j0 in range(0, t, block_k):
        st = s[..., j0:j0 + block_k]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pt = torch.exp(st - m_new)
        l = l * alpha + pt.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            pt = philox.apply_keep(pt, keep[..., j0:j0 + block_k],
                                   dropout_rate)
        acc = acc * alpha + pt.to(v.dtype).float() @ vf[..., j0:j0 + block_k, :]
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(q_u.dtype), (m + torch.log(l))[..., 0]


def rel_flash_attention_bwd_plain(q_u, q_v, k, v, p, lengths, out, lse, g,
                                  seed=None, *, scale: float,
                                  dropout_rate: float = 0.0,
                                  keep: Optional[torch.Tensor] = None,
                                  chunk_size: int = 0, left_chunks: int = -1,
                                  accumulate: torch.dtype = torch.float32):
    """The backward at the kernels' rounding points: (dq_u, dq_v, dk, dv, dp)
    for the output cotangent g [B, H, T, Dh] (q_u.dtype), given the
    forward's out and lse.

    As espnet_slurp_tpu/ops/pallas/flash_attention.py:_dkv_kernel and
    _dq_kernel: scores recomputed in fp32 from q_u.dtype operands, P =
    exp(s - lse) on visible pairs, dP = g v^T, delta = rowsum(g * out), ds =
    P (dP - delta) scale; P, ds and the skewed rawg (rawg[i, T-1-i+j] =
    ds[i, j]) rounded to q_u.dtype before the products that take them;
    fp32 accumulation, dp summed over the batch; dp returned in p.dtype,
    the rest in q_u.dtype. A query row with no visible key (lse at NEG)
    takes P = 1/T and ds = 0 (the plain autograd's gradient; the reference
    differs there, ROADMAP.md queue 3). At a rate above 0 (``seed``,
    ``keep`` as in rel_flash_attention_plain) dv takes the dropped P and dP
    is masked and scaled the same way before ds; P in ds stays undropped.
    ``accumulate`` float64 computes between the same rounding points in
    double precision: how far two summation orders fall apart on given
    inputs. Nothing on the main path calls it."""
    b, h, t, _ = q_u.shape
    dt = q_u.dtype
    qu, qv, kf, vf, pf, gf = (x.to(accumulate)
                              for x in (q_u, q_v, k, v, p, g))
    idx = rel_shift_index(t, q_u.device).expand(b, h, t, t)
    bd = (qv @ pf.transpose(-1, -2)).gather(-1, idx)
    s = (qu @ kf.transpose(-1, -2) + bd) * scale
    ok = allowed_mask(t, lengths, chunk_size, left_chunks)
    dead = (lse < 0.5 * NEG)[..., None]
    prob = torch.where(ok, torch.exp(s - lse[..., None].to(accumulate)),
                       0.0)
    prob = torch.where(dead, 1.0 / t, prob)
    delta = (gf * out.to(accumulate)).sum(-1, keepdim=True)
    dprob, pd = gf @ vf.transpose(-1, -2), prob
    if dropout_rate > 0.0:
        kp = dropout_keep(seed, dropout_rate, b, h, t, keep)
        dprob = philox.apply_keep(dprob, kp, dropout_rate)
        pd = philox.apply_keep(prob, kp, dropout_rate)
    ds = prob * (dprob - delta) * scale
    ds = torch.where(ok & ~dead, ds, 0.0).to(dt).to(accumulate)
    rawg = torch.zeros(b, h, t, 2 * t, device=q_u.device,
                       dtype=accumulate).scatter_(-1, idx, ds)
    dv = pd.to(dt).to(accumulate).transpose(-1, -2) @ gf
    dp = (rawg.transpose(-1, -2) @ qv).sum(0)
    return ((ds @ kf).to(dt), (rawg @ pf).to(dt),
            (ds.transpose(-1, -2) @ qu).to(dt), dv.to(dt), dp.to(p.dtype))


def _check(q_u, q_v, k, v, p, lengths):
    if q_u.ndim != 4:
        raise ValueError("rel_flash_attention: q_u must be [B, H, T, Dh]")
    b, h, t, dh = q_u.shape
    for name, x in (("q_v", q_v), ("k", k), ("v", v)):
        if x.shape != q_u.shape:
            raise ValueError(f"rel_flash_attention: {name} {tuple(x.shape)} "
                             f"!= q_u {tuple(q_u.shape)}")
    if tuple(p.shape) != (h, 2 * t, dh):
        raise ValueError(f"rel_flash_attention: p {tuple(p.shape)} != "
                         f"{(h, 2 * t, dh)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError("rel_flash_attention: lengths must be int32 [B]")
    if q_u.dtype not in build.DTYPE_CODES or any(
            x.dtype != q_u.dtype for x in (q_v, k, v, p)):
        raise TypeError("rel_flash_attention: q_u, q_v, k, v, p must share "
                        "float32 or bfloat16")
    args = (q_u, q_v, k, v, p, lengths)
    if len({x.device for x in args}) != 1:
        raise ValueError("rel_flash_attention: all arguments must be on one "
                         "device")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("rel_flash_attention: all arguments must be "
                         "contiguous")


def _launch_fwd(q_u, q_v, k, v, p, lengths, scale, chunk_size, left_chunks,
                seed=None, rate=0.0):
    b, h, t, dh = q_u.shape
    out = torch.empty_like(q_u)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q_u.device)
    build.check(build.library().espnet_rel_flash_fwd(
        build.DTYPE_CODES[q_u.dtype], q_u.data_ptr(), q_v.data_ptr(),
        k.data_ptr(), v.data_ptr(), p.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, t, dh, float(scale),
        int(chunk_size), int(left_chunks), *philox.launch_args(seed, rate),
        build.stream_ptr(q_u)), "rel_flash_attention")
    rel_flash_attention_fwd.launches += 1
    return out, lse


def _launch_bwd(q_u, q_v, k, v, p, lengths, out, lse, g, scale, chunk_size,
                left_chunks, seed=None, rate=0.0):
    b, h, t, dh = q_u.shape
    # delta = rowsum(dO * out), outside the kernels as in the reference.
    delta = (g.float() * out.float()).sum(-1).contiguous()
    grads = [torch.empty_like(q_u) for _ in range(4)]
    dp = torch.zeros(h, 2 * t, dh, dtype=torch.float32, device=q_u.device)
    build.check(build.library().espnet_rel_flash_bwd(
        build.DTYPE_CODES[q_u.dtype], q_u.data_ptr(), q_v.data_ptr(),
        k.data_ptr(), v.data_ptr(), p.data_ptr(), lengths.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(x.data_ptr() for x in grads), dp.data_ptr(), b, h, t, dh,
        float(scale), int(chunk_size), int(left_chunks),
        *philox.launch_args(seed, rate), build.stream_ptr(q_u)),
        "rel_flash_attention backward")
    rel_flash_attention_fwd.bwd_launches += 1
    return (*grads, dp.to(p.dtype))


# Head widths of the redesigned routes, by dtype: bf16 mma.sync at Dh 32 /
# 64, fp32 register micro-tiles at Dh 32 / 64 / 128
# (csrc/flash_attention.cu: rel_fwd / rel_dkv / rel_dq, rel_f32).
PAD_WIDTHS = {torch.bfloat16: (32, 64), torch.float32: (32, 64, 128)}


def kernel_head_width(dh: int, dtype: torch.dtype) -> int:
    """The Dh the kernels run a head width ``dh`` at: ``dh`` itself when it
    is a multiple of 16 (the WMMA routes take every such Dh); else the
    next width of a redesigned route for ``dtype`` (the recipe's KA2G
    encoder, 144 wide with 4 heads, has Dh 36 -> 64). Raises when no route
    takes ``dh``."""
    if dh % 16 == 0:
        return dh
    for w in PAD_WIDTHS.get(dtype, ()):
        if dh < w:
            return w
    raise ValueError(f"rel_flash_attention kernel: no route takes Dh {dh} "
                     f"in {dtype} (a multiple of 16, or up to "
                     f"{max(PAD_WIDTHS.get(dtype, (0,)))} zero-padded)")


def pad_heads(fn, q_u, q_v, k, v, p, width: int):
    """``fn(q_u, q_v, k, v, p) -> (out, lse)`` at head width ``width``:
    q_u, q_v, k, v and p zero-padded along Dh, out sliced back. The zero
    columns add nothing to (q+u)·kᵀ or (q+v)·pᵀ (the caller passes the
    scale of the true Dh) and make zero output columns, so out and lse are
    those of the unpadded call; the pads' and the slice's backwards drop
    the padded columns' gradients."""
    dh = q_u.shape[-1]
    if width == dh:
        return fn(q_u, q_v, k, v, p)
    pad = lambda x: torch.nn.functional.pad(x, (0, width - dh))
    out, lse = fn(pad(q_u), pad(q_v), pad(k), pad(v), pad(p))
    return out[..., :dh], lse


class _RelFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, lengths, seed, scale, rate,
                chunk_size, left_chunks):
        out, lse = _launch_fwd(q_u, q_v, k, v, p, lengths, scale,
                               chunk_size, left_chunks, seed, rate)
        ctx.save_for_backward(q_u, q_v, k, v, p, lengths, out, lse, seed)
        ctx.args = (scale, chunk_size, left_chunks)
        ctx.rate = rate
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q_u, q_v, k, v, p, lengths, out, lse, seed = ctx.saved_tensors
        grads = _launch_bwd(q_u, q_v, k, v, p, lengths, out, lse,
                            g.to(q_u.dtype).contiguous(), *ctx.args, seed,
                            ctx.rate)
        return (*grads, None, None, None, None, None, None)


def rel_flash_attention_fwd(q_u, q_v, k, v, p, lengths, seed=None, *,
                            scale: float, dropout_rate: float = 0.0,
                            chunk_size: int = 0, left_chunks: int = -1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, Dh], lse fp32 [B, H, T]) for any T.

    q_u = q + pos_bias_u, q_v = q + pos_bias_v, k, v: [B, H, T, Dh];
    p: [H, 2T, Dh] position projections for offsets T-1 ... -(T-1) (row
    2T-1 unused); lengths: int32 [B] valid keys. Padded query rows hold
    values for a row with the same keys; mask them outside. ``out`` is
    differentiable in q_u, q_v, k, v and p (on the card through the
    backward kernels; ``lse`` is not). ``dropout_rate`` (in [0, 1)) drops
    the probabilities under ``seed`` (int32 [1] on the inputs' device;
    zeros when None, as the reference); every launch takes it, in both
    dtypes and at every Dh."""
    rate = float(dropout_rate)
    seed = philox.checked_seed(seed, rate, q_u.device, "rel_flash_attention")
    _check(q_u, q_v, k, v, p, lengths)
    if q_u.device.type == "cpu":
        return rel_flash_attention_plain(
            q_u, q_v, k, v, p, lengths, seed, scale=scale, dropout_rate=rate,
            chunk_size=chunk_size, left_chunks=left_chunks)
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_flash_attention: unsupported device "
                         f"{q_u.device}")
    width = kernel_head_width(q_u.shape[-1], q_u.dtype)

    def launch(q_u, q_v, k, v, p):
        for name, x in (("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v),
                        ("p", p)):
            build.check_aligned(name, x)
        return _RelFlash.apply(q_u, q_v, k, v, p, lengths, seed,
                               float(scale), rate, int(chunk_size),
                               int(left_chunks))

    return pad_heads(launch, q_u, q_v, k, v, p, width)


rel_flash_attention_fwd.launches = 0
rel_flash_attention_fwd.bwd_launches = 0


def rel_flash_attention(q_u, q_v, k, v, p, lengths, seed=None, *,
                        scale: float, dropout_rate: float = 0.0,
                        chunk_size: int = 0, left_chunks: int = -1
                        ) -> torch.Tensor:
    """The reference's signature: returns out [B, H, T, Dh] only."""
    return rel_flash_attention_fwd(q_u, q_v, k, v, p, lengths, seed,
                                   scale=scale, dropout_rate=dropout_rate,
                                   chunk_size=chunk_size,
                                   left_chunks=left_chunks)[0]
