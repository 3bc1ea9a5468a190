"""RNN-T (transducer) lattice forward-backward (kernel K5).

Port of espnet_slurp_tpu/ops/pallas/transducer.py:rnnt_lattice_pallas
(``_fwd_kernel`` via ``_pallas_alpha``, ``_bwd_kernel`` via ``_rnnt_bwd``).
``rnnt_lattice`` takes the gathered blank and emit log-prob tables and
returns the per-row negative log-likelihood. On CUDA tensors it launches
the hand-written kernels in ``csrc/transducer.cu`` (alpha along the
lattice's anti-diagonals forward; beta and the posteriors backward), a
route by U1: up to ``warp_states()`` (256) one warp per utterance with the
states in registers (``rnnt_warp``), past it one block per utterance
(``rnnt_block``). The alpha residual the forward keeps for the backward is
diagonal-major, [B, T + U1 - 1, U1] fp64. On CPU tensors it runs
``rnnt_lattice_plain``, the same recursion in plain PyTorch, whose gradient
is PyTorch's autograd. A CUDA tensor the kernels do not take raises.

Unlike the reference, the tables are not padded to 128 lanes, and a row
with ``tlen < 1`` (no frame) gives loss 0 and gradient 0 instead of reading
``alpha[-1]``; the caller's feasibility mask zeroes such rows in both.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG = -1e30


def _lse(a, b):
    m = torch.maximum(a, b).clamp_min(NEG).detach()
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def rnnt_lattice_plain(blank: torch.Tensor, emit: torch.Tensor,
                       tlen: torch.Tensor, ulen: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: loss [B] (fp32), differentiable in ``blank``
    and ``emit``.

    blank, emit: f32 [B, T, U1]; tlen, ulen: [B] frames and labels of each
    row (ulen clamped to [0, U1 - 1], tlen to T). The recursion walks the
    anti-diagonals in fp64, as the kernel does: at T' ~ 470 the alphas
    reach ~ -4000, where fp32's spacing shows in the gradient."""
    out_dtype = blank.dtype
    bl, em = blank.double(), emit.double()
    b, t, u1 = bl.shape
    dev = bl.device
    u = torch.arange(u1, device=dev)
    tl = tlen.to(dev).long().clamp(max=t)
    ul = ulen.to(dev).long().clamp(0, u1 - 1)
    prev = torch.where(u == 0, 0.0, NEG).to(bl.dtype).expand(b, u1)
    diags = [prev]
    neg = torch.full((b, 1), NEG, dtype=bl.dtype, device=dev)
    for d in range(1, t + u1 - 1):
        tt = d - u  # frame of each u on this diagonal
        valid = (tt >= 0) & (tt < t)
        src = (tt - 1).clamp(0, t - 1)
        from_blank = torch.where(valid & (tt >= 1),
                                 prev + bl[:, src, u], NEG)
        em_d = em[:, tt.clamp(0, t - 1), (u - 1).clamp_min(0)]
        from_emit = torch.where(valid & (u >= 1),
                                torch.cat([neg, prev[:, :-1]], 1) + em_d, NEG)
        prev = torch.where(valid, _lse(from_blank, from_emit).clamp_min(NEG),
                           NEG)
        diags.append(prev)
    rows = torch.arange(b, device=dev)
    last = (tl - 1).clamp_min(0)
    alpha_fin = torch.stack(diags)[last + ul, rows, ul]
    ll = alpha_fin + bl[rows, last, ul]
    return torch.where(tl >= 1, -ll, 0.0).to(out_dtype)


def _check(blank, emit, tlen, ulen):
    if blank.ndim != 3 or emit.shape != blank.shape:
        raise ValueError("rnnt_lattice: blank and emit must be [B, T, U1]")
    if blank.dtype != torch.float32 or emit.dtype != torch.float32:
        raise TypeError("rnnt_lattice: blank and emit must be float32")
    b = blank.shape[0]
    for name, x in (("tlen", tlen), ("ulen", ulen)):
        if tuple(x.shape) != (b,) or x.dtype != torch.int32:
            raise ValueError(f"rnnt_lattice: {name} must be int32 [B]")
    if len({x.device for x in (blank, emit, tlen, ulen)}) != 1:
        raise ValueError("rnnt_lattice: all arguments must be on one device")


def warp_states() -> int:
    """The largest U1 the one-warp-per-utterance route takes (the kernels'
    constant; larger U1 take the block route)."""
    return build.library().espnet_rnnt_warp_states()


def info(which: int, u1: int) -> tuple:
    """(registers a thread, shared bytes, local (spill) bytes, blocks per
    SM) of the forward (``which`` 0) or backward (1) kernel that launches
    for U1 states, from the built library."""
    buf = (ctypes.c_int * 4)()
    build.check(build.library().espnet_rnnt_info(which, u1, buf),
                "rnnt_lattice kernel info")
    return tuple(buf)


def _launch_fwd(blank, emit, tlen, ulen):
    b, t, u1 = blank.shape
    loss = torch.empty(b, dtype=torch.float32, device=blank.device)
    alpha = torch.empty(b, t + u1 - 1, u1, dtype=torch.float64,
                        device=blank.device)
    build.check(build.library().espnet_rnnt_fwd(
        blank.data_ptr(), emit.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
        loss.data_ptr(), alpha.data_ptr(), b, t, u1, build.stream_ptr(blank)),
        "rnnt_lattice forward")
    rnnt_lattice.launches += 1
    return loss, alpha


def _launch_bwd(blank, emit, tlen, ulen, alpha, g):
    b, t, u1 = blank.shape
    dblank = torch.empty_like(blank)
    demit = torch.empty_like(emit)
    build.check(build.library().espnet_rnnt_bwd(
        blank.data_ptr(), emit.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
        alpha.data_ptr(), g.data_ptr(), dblank.data_ptr(), demit.data_ptr(),
        b, t, u1, build.stream_ptr(blank)), "rnnt_lattice backward")
    rnnt_lattice.bwd_launches += 1
    return dblank, demit


class _RnntLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank, emit, tlen, ulen):
        loss, alpha = _launch_fwd(blank, emit, tlen, ulen)
        ctx.save_for_backward(blank, emit, tlen, ulen, alpha)
        return loss

    @staticmethod
    def backward(ctx, g):
        blank, emit, tlen, ulen, alpha = ctx.saved_tensors
        dblank, demit = _launch_bwd(blank, emit, tlen, ulen, alpha,
                                    g.float().contiguous())
        return dblank, demit, None, None


def rnnt_lattice(blank: torch.Tensor, emit: torch.Tensor, tlen: torch.Tensor,
                 ulen: torch.Tensor) -> torch.Tensor:
    """Per-row RNN-T negative log-likelihood [B]; see ``rnnt_lattice_plain``
    for the arguments. Differentiable in ``blank`` and ``emit``: on the card
    the backward is the kernel's beta recursion."""
    _check(blank, emit, tlen, ulen)
    if blank.device.type == "cpu":
        return rnnt_lattice_plain(blank, emit, tlen, ulen)
    if blank.device.type != "cuda":
        raise ValueError(f"rnnt_lattice: unsupported device {blank.device}")
    if blank.shape[2] > 3072:
        raise ValueError("rnnt_lattice kernel: U1 must be at most 3072")
    if blank.shape[0] == 0 or blank.shape[1] == 0:
        raise ValueError("rnnt_lattice kernel: needs B > 0 and T > 0")
    return _RnntLattice.apply(*(x.contiguous() for x in (blank, emit, tlen,
                                                          ulen)))


rnnt_lattice.launches = 0
rnnt_lattice.bwd_launches = 0
