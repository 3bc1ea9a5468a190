"""CTC lattice forward-backward (kernel K1).

Port of espnet_slurp_tpu/ops/pallas/ctc.py (``_ctc_core`` with its
``_fwd_kernel`` / ``_bwd_kernel``; its entry points ``ctc_loss_pallas`` and
``ctc_loss_pallas_logits`` are ops/ctc.py's ``ctc_loss`` and
``ctc_loss_logits`` here). ``ctc_lattice`` takes the gathered emissions
of the blank-interleaved label sequence and returns the per-row negative
log-likelihood. On CUDA tensors it launches the hand-written kernels in
``csrc/ctc.cu``, a route by S: up to ``warp_states()`` (256) states one warp
per utterance with the states in registers (``ctc_warp``), past it one
block per utterance (``ctc_block``); forward the alpha recursion, backward
the beta recursion and the posterior. On CPU tensors it runs
``ctc_lattice_plain``, the same recursion in plain PyTorch (the same
``_lse3`` arithmetic), whose gradient is PyTorch's autograd. A CUDA tensor
the kernels do not take raises.

One deliberate difference from the reference kernel: for an empty label
sequence (``last == 0``) the reference counts ``alpha[last]`` twice
(``alpha[max(last - 1, 0)]`` is the same state), so its loss is log 2 too
small. Here, as in the reference's scan (espnet_slurp_tpu/ops/ctc.py) and
``torch.nn.functional.ctc_loss``, the state before ``last`` is NEG then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

NEG = -1e30


def _lse3(a, b, c):
    """log(e^a + e^b + e^c) as csrc/ctc.cu:lse3_n forms it: the largest term
    t plus log1p(exp(x - t) + exp(y - t)) of the other two, the largest
    term's own exp being 1 (t floored at NEG, which the forward's values
    never fall below). Its gradient is the softmax of the three, ties
    included."""
    m = torch.maximum(torch.maximum(a, b), c)
    a_top, b_top = a == m, b == m
    top = torch.where(a_top, a, torch.where(b_top, b, c)).clamp_min(NEG)
    x = torch.where(a_top, b, a)
    y = torch.where(a_top | b_top, c, b)
    return top + torch.log1p(torch.exp(x - top) + torch.exp(y - top))


def _lse(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    m = m.clamp_min(NEG).detach()
    return m + torch.log(sum(torch.exp(x - m) for x in xs))


def ctc_lattice_plain(emit: torch.Tensor, skip: torch.Tensor,
                      tlen: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: loss [B] (fp32), differentiable in ``emit``.

    emit: f32 [B, T, S]; skip: f32 [B, S] (> 0: the s-2 -> s skip is
    allowed); tlen: [B] valid frames (later frames are frozen and get no
    gradient); last: [B]
    index of the trailing blank (2 U_b). The recursion runs in fp64, as the
    kernel's does: at T' ~ 470 the alphas reach ~ -4000, where fp32's
    spacing (~5e-4) shows up in the gradient."""
    out_dtype = emit.dtype
    emit = emit.double()
    b, t, s = emit.shape
    col = torch.arange(s, device=emit.device)
    allow = skip > 0
    neg = torch.full((b, 1), NEG, dtype=emit.dtype, device=emit.device)
    tl = tlen.to(emit.device).long()
    # A row with tlen 0 has no frame: its loss reads emit[:, 0], but its
    # gradient is 0, as the kernels (and the reference kernel) give it.
    e0 = torch.where((tl > 0)[:, None], emit[:, 0], emit[:, 0].detach())
    alpha = torch.where(col < 2, e0, NEG)
    for i in range(1, t):
        a1 = torch.cat([neg, alpha[:, :-1]], 1)
        a2 = torch.where(allow, torch.cat([neg, neg, alpha[:, :-2]], 1)[:, :s],
                         NEG)
        new = (_lse3(alpha, a1, a2) + emit[:, i]).clamp_min(NEG)
        alpha = torch.where((i < tl)[:, None], new, alpha)
    lst = last.to(emit.device).long().clamp(0, s - 1)
    a_last = alpha.gather(1, lst[:, None])[:, 0]
    a_prev = alpha.gather(1, (lst - 1).clamp_min(0)[:, None])[:, 0]
    a_prev = torch.where(lst > 0, a_prev, NEG)
    return (-_lse(a_last, a_prev)).to(out_dtype)


def _check(emit, skip, tlen, last):
    if emit.ndim != 3:
        raise ValueError("ctc_lattice: emit must be [B, T, S]")
    b, _, s = emit.shape
    if emit.dtype != torch.float32 or skip.dtype != torch.float32:
        raise TypeError("ctc_lattice: emit and skip must be float32")
    if tuple(skip.shape) != (b, s):
        raise ValueError(f"ctc_lattice: skip {tuple(skip.shape)} != {(b, s)}")
    for name, x in (("tlen", tlen), ("last", last)):
        if tuple(x.shape) != (b,) or x.dtype != torch.int32:
            raise ValueError(f"ctc_lattice: {name} must be int32 [B]")
    if len({x.device for x in (emit, skip, tlen, last)}) != 1:
        raise ValueError("ctc_lattice: all arguments must be on one device")


def warp_states() -> int:
    """The largest S the one-warp-per-utterance route takes (the kernels'
    constant; larger S take the block route)."""
    return build.library().espnet_ctc_warp_states()


def _launch_fwd(emit, skip, tlen, last):
    b, t, s = emit.shape
    loss = torch.empty(b, dtype=torch.float32, device=emit.device)
    alpha = torch.empty(b, t, s, dtype=torch.float64, device=emit.device)
    build.check(build.library().espnet_ctc_fwd(
        emit.data_ptr(), skip.data_ptr(), tlen.data_ptr(), last.data_ptr(),
        loss.data_ptr(), alpha.data_ptr(), b, t, s, build.stream_ptr(emit)),
        "ctc_lattice forward")
    ctc_lattice.launches += 1
    return loss, alpha


def _launch_bwd(emit, skip, tlen, last, alpha, g):
    b, t, s = emit.shape
    demit = torch.empty_like(emit)
    build.check(build.library().espnet_ctc_bwd(
        emit.data_ptr(), skip.data_ptr(), tlen.data_ptr(), last.data_ptr(),
        alpha.data_ptr(), g.data_ptr(), demit.data_ptr(),
        b, t, s, build.stream_ptr(emit)), "ctc_lattice backward")
    ctc_lattice.bwd_launches += 1
    return demit


class _CtcLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emit, skip, tlen, last):
        loss, alpha = _launch_fwd(emit, skip, tlen, last)
        ctx.save_for_backward(emit, skip, tlen, last, alpha)
        return loss

    @staticmethod
    def backward(ctx, g):
        emit, skip, tlen, last, alpha = ctx.saved_tensors
        demit = _launch_bwd(emit, skip, tlen, last, alpha,
                            g.float().contiguous())
        return demit, None, None, None


def ctc_lattice(emit: torch.Tensor, skip: torch.Tensor, tlen: torch.Tensor,
                last: torch.Tensor) -> torch.Tensor:
    """Per-row CTC negative log-likelihood [B] of the lattice; see
    ``ctc_lattice_plain`` for the arguments. Differentiable in ``emit``:
    on the card the backward is the kernel's beta recursion."""
    _check(emit, skip, tlen, last)
    if emit.device.type == "cpu":
        return ctc_lattice_plain(emit, skip, tlen, last)
    if emit.device.type != "cuda":
        raise ValueError(f"ctc_lattice: unsupported device {emit.device}")
    if emit.shape[2] > 3072:
        raise ValueError("ctc_lattice kernel: S must be at most 3072")
    args = [x.contiguous() for x in (emit, skip, tlen, last)]
    if emit.shape[0] == 0 or emit.shape[1] == 0:
        raise ValueError("ctc_lattice kernel: needs B > 0 and T > 0")
    return _CtcLattice.apply(*args)


ctc_lattice.launches = 0
ctc_lattice.bwd_launches = 0


def extend_labels(labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: int = 0):
    """(ext [B, S] int64, skip f32 [B, S], smax [B], last int32 [B]) of the
    blank-interleaved label sequence, S = 2U + 1 (no lane padding)."""
    b, u = labels.shape
    s = 2 * u + 1
    ext = torch.full((b, s), blank_id, dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels.long().clamp_min(0)
    prev2 = F.pad(ext, (2, 0), value=blank_id)[:, :s]
    skip = ((ext != blank_id) & (ext != prev2)).float()
    ll = label_lengths.to(labels.device).long()
    return ext, skip, 2 * ll + 1, (2 * ll).to(torch.int32)


def mask_emit(emit: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    """NEG in the columns at or past each row's 2 U_b + 1 states."""
    col = torch.arange(emit.shape[2], device=emit.device)
    return torch.where((col[None, :] < smax[:, None])[:, None, :], emit, NEG)


def lattice_loss(emit: torch.Tensor, logit_lengths: torch.Tensor,
                 label_lengths: torch.Tensor, skip: torch.Tensor,
                 smax: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Per-example loss [B] from gathered emissions [B, T, S]: masked by
    ``mask_emit``, through the lattice, then zero_infinity (0 where U > T
    or the likelihood saturated at NEG, as with T < U + adjacent
    repeats)."""
    loss = ctc_lattice(mask_emit(emit, smax).contiguous(), skip,
                       logit_lengths.to(torch.int32), last)
    feasible = (label_lengths.to(loss.device) <= logit_lengths.to(
        loss.device)) & (loss < -NEG / 2)
    return torch.where(feasible, loss, torch.zeros_like(loss))
