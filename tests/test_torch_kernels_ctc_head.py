"""Kernel K4 (fused CTC head) against the reference.

espnet_slurp_tpu_torch/ops/kernels/ctc_head.py on CPU tensors runs
fused_ctc_head_emit_plain (gradients by autograd); it is held to the
Pallas fused_ctc_head_emit in interpret mode, emit and the vector-Jacobian
products dhs, dW, db for the same random cotangent, at D = 128 and a V that
is not a multiple of 128, with duplicate labels in ext. The port takes the
weight as [V, D] (nn.Linear's layout), the reference as [D, V]: the port
gets the transpose of the same weight, and its dW is compared transposed. Then
ctc_loss_pallas_head end to end (loss and gradients) against the JAX one.
Tolerances as in tests/test_ctc_head.py: 1e-5 for values, gradients
2e-4 * max(1, max |ref|) (fp32).

fused_ctc_head_emit_bwd_plain, the backward at the kernels' rounding
points, is held to jax.vjp of the Pallas kernel in bf16 and fp32, the
plain forward and backward also at the edges of the card's tiling in both
dtypes (V 77 and 333, B 8 x T 17, a label over many states, labels at 0
and V - 1 and outside [0, V), which the port clamps). In bf16
the reference rounds two values that the port keeps in fp32, both artifacts
of its one-hot gather / scatter product on the TPU's matrix unit: the
gathered logit before z is subtracted, and the cotangent g before the
scatter. The port keeps both unrounded (ROADMAP queue 3);
test_bf16_rounding_points_diverge_from_the_reference holds the size of
that divergence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.ops.pallas.ctc_head import (
    ctc_loss_pallas_head as jax_head_loss, fused_ctc_head_emit as jax_emit)
from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
from torch_parity import t

B, T, D, V, SP = 2, 37, 128, 77, 128


def _inputs(seed=0, t_len=T, v=V, bsz=B):
    rng = np.random.RandomState(seed)
    hs = (rng.randn(bsz, t_len, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, v) * 0.1).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    ext = rng.randint(0, v, size=(bsz, SP)).astype(np.int32)
    ext[:, 5] = ext[:, 3]  # duplicates must add in the scatter
    ext[:, 0] = 0
    ext[:, 2] = 0
    g = rng.randn(bsz, t_len, SP).astype(np.float32)
    return hs, w, b, ext, g


def _tol(ref):
    return 2e-4 * max(1.0, float(np.abs(ref).max()))


def _port_args(hs, w, b):
    """Leaves hs, w [V, D] (the reference's [D, V] transposed), b."""
    return [t(x).requires_grad_(True)
            for x in (hs, np.ascontiguousarray(w.T), b)]


def _check_grads(args, ref_grads):
    for name, a, r in zip(("dhs", "dW", "db"), args, ref_grads):
        r = np.asarray(r)
        got = a.grad.numpy().T if name == "dW" else a.grad.numpy()
        np.testing.assert_allclose(got, r, rtol=0, atol=_tol(r),
                                   err_msg=name)


@pytest.mark.parametrize("t_len,v", [(T, V), (133, 130)])
def test_plain_matches_pallas_interpret(t_len, v):
    hs, w, b, ext, g = _inputs(t_len=t_len, v=v)
    ref, vjp = jax.vjp(lambda h, ww, bb: jax_emit(h, ww, bb, jnp.asarray(ext),
                                                  vocab=v, interpret=True),
                       jnp.asarray(hs), jnp.asarray(w), jnp.asarray(b))
    ref_grads = vjp(jnp.asarray(g))
    args = _port_args(hs, w, b)
    out = kh.fused_ctc_head_emit(*args, t(ext))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    out.backward(t(g))
    _check_grads(args, ref_grads)


def test_wrapper_on_cpu_is_plain_and_not_counted():
    hs, w, b, ext, _ = map(t, _inputs(seed=1))
    w = w.t()  # [V, D]
    before = (kh.fused_ctc_head_emit.launches,
              kh.fused_ctc_head_emit.bwd_launches)
    out = kh.fused_ctc_head_emit(hs, w, b, ext)
    assert (kh.fused_ctc_head_emit.launches,
            kh.fused_ctc_head_emit.bwd_launches) == before
    torch.testing.assert_close(
        out, kh.fused_ctc_head_emit_plain(hs, w, b, ext), atol=0, rtol=0)
    with pytest.raises(TypeError):
        kh.fused_ctc_head_emit(hs, w, b, ext.long())
    with pytest.raises(ValueError):
        kh.fused_ctc_head_emit(hs, w.t(), b, ext)


def test_ctc_loss_pallas_head_matches_jax():
    rng = np.random.RandomState(2)
    hs, w, b, _, _ = _inputs(seed=2)
    u = 6
    labels = rng.randint(1, V, size=(B, u)).astype(np.int32)
    labels[0, 3] = labels[0, 2]
    tlen = np.asarray([T, T - 11], np.int32)
    ulen = np.asarray([u, u - 2], np.int32)
    jf = lambda h, ww, bb: jax_head_loss(h, ww, bb, tlen, labels, ulen)
    ref = jf(*map(jnp.asarray, (hs, w, b)))
    ref_g = jax.grad(lambda *a: jf(*a).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (hs, w, b)))
    args = _port_args(hs, w, b)
    loss = kh.ctc_loss_pallas_head(*args, t(tlen), t(labels), t(ulen))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    loss.sum().backward()
    _check_grads(args, ref_g)


def _z(hs, w, b):
    """The forward's logsumexp over V, as the kernel saves it."""
    return torch.logsumexp(hs.float() @ w.float().t() + b, -1)


def _bf16_exact(x):
    """x rounded to bf16 and back: a cotangent the reference's own rounding
    of g leaves unchanged."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _pallas_vjp(hs, w, b, ext, g, v):
    """emit and (dhs, dW [D, V], db) of the Pallas kernel, interpret mode,
    as float32 numpy arrays."""
    ref, vjp = jax.vjp(lambda h, ww, bb: jax_emit(h, ww, bb, jnp.asarray(ext),
                                                  vocab=v, interpret=True),
                       hs, w, jnp.asarray(b))
    return np.asarray(ref), [np.asarray(jnp.asarray(x, jnp.float32))
                             for x in vjp(jnp.asarray(g))]


def _as_port(hs, w, dtype):
    """The reference's (rounded) hs and w [D, V] as the port's hs and w [V,
    D] in dtype."""
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return (t(f32(hs)).to(dtype),
            t(np.ascontiguousarray(f32(w).T)).to(dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t_len,v", [(T, V), (133, 130)])
def test_bwd_plain_matches_pallas_vjp(dtype, t_len, v):
    """fused_ctc_head_emit_bwd_plain against jax.vjp of the Pallas kernel
    (its _bwd_kernel, interpret mode): V not a multiple of 128, T not a
    multiple of the kernel's row tile (37 of 40; 133 of 2 x 128), duplicate
    labels. The cotangent is exact in bf16, so the reference's rounding of
    g (queue 3) changes nothing and the two compute the same function with
    the same rounding of dlg. bf16: what differs is the fp32 summation
    order, which can flip a rounding of dlg, dhs or dW by one unit in the
    last place (2^-8 to 2^-7 of the value): tol 2^-7 of max |ref|. fp32:
    summation order only, tol 1e-5."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    hs, w, b, ext, g = _inputs(seed=3, t_len=t_len, v=v)
    g = _bf16_exact(g)
    jhs, jw = jnp.asarray(hs, jdt), jnp.asarray(w, jdt)
    _, ref = _pallas_vjp(jhs, jw, b, ext, g, v)
    ths, tw = _as_port(jhs, jw, tdt)
    out = kh.fused_ctc_head_emit_bwd_plain(ths, tw, t(b), t(ext),
                                           _z(ths, tw, t(b)), t(g))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for name, a, r in zip(("dhs", "dW", "db"), out, ref):
        assert a.dtype == (torch.float32 if name == "db" else tdt), name
        a = a.float().numpy()
        a = a.T if name == "dW" else a
        assert a.shape == r.shape, name
        err = np.abs(a - r).max() / np.abs(r).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


EDGE_CASES = [(B, T, 77, "repeated"), (B, T, 333, "repeated"),
              (8, 17, 130, "repeated"), (B, T, 77, "out_of_range"),
              (8, 17, 333, "out_of_range")]


def _edge_id(case):
    return "-".join(map(str, case))


@pytest.mark.parametrize("bsz,t_len,v,labels,dtype", [
    pytest.param(*case, "float32", id=_edge_id(case)) for case in EDGE_CASES
] + [pytest.param(*case, "bfloat16", id=_edge_id(case) + "-bfloat16")
     for case in EDGE_CASES])
def test_fp32_plain_matches_pallas_at_the_kernel_edges(bsz, t_len, v, labels,
                                                       dtype):
    """The plain forward and backward (fused_ctc_head_emit_plain and
    fused_ctc_head_emit_bwd_plain), which the card's routes are held to,
    against jax.vjp of the Pallas kernel in interpret mode at the edges of
    their tiling, in fp32 and bf16: V 77 and 333 (ragged against 128-column
    tiles, not multiples of 4 or 8; 333 in 3 V splits of lse at these N),
    B 8 x T 17 (one 128-row tile spans all 8 utterances; N not a multiple
    of 128), a label repeated over 5 states besides the file's duplicates,
    labels at 0 and V - 1, and labels below 0 and at or past V, which the
    port (kernels and plain versions) clamps into [0, V): the reference,
    whose contract is entries < V, is given them clamped. fp32 tolerances:
    emit 1e-5 (as test_plain_matches_pallas_interpret), gradients 1e-5 of
    max |ref| (fp32 summation order, as test_bwd_plain_matches_pallas_vjp).
    bf16 (hs and W rounded to bf16 on both sides; the cotangent exact in
    bf16): emit within 2^-8 of the gathered logit + 1e-5 (the reference
    rounds that logit to bf16, the port does not: ROADMAP queue 3, held by
    test_bf16_rounding_points_diverge_from_the_reference), gradients 2^-7
    of max |ref| (a rounding of dlg, dhs or dW flipped by summation order,
    as test_bwd_plain_matches_pallas_vjp)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    hs, w, b, ext, g = _inputs(seed=4, t_len=t_len, v=v, bsz=bsz)
    if labels == "repeated":
        ext[:, 7:12] = ext[:, 6:7]
        ext[:, 13] = v - 1
    else:
        ext[:, 9], ext[:, 11], ext[0, 13], ext[-1, 15] = -3, v + 5, v, v - 1
    if dtype == "bfloat16":
        g = _bf16_exact(g)
    clamped = np.clip(ext, 0, v - 1)
    jhs, jw = jnp.asarray(hs, jdt), jnp.asarray(w, jdt)
    ref, ref_grads = _pallas_vjp(jhs, jw, b, clamped, g, v)
    ths, tw = _as_port(jhs, jw, tdt)
    out = kh.fused_ctc_head_emit_plain(ths, tw, t(b), t(ext)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        lg = ths.float() @ tw.float().t() + t(b)
        gathered = lg.gather(2, t(clamped).long()[:, None, :].expand(
            bsz, t_len, -1)).numpy()
        assert (np.abs(out - ref) <= 2.0 ** -8 * np.abs(gathered)
                + 1e-5).all()
    grads = kh.fused_ctc_head_emit_bwd_plain(ths, tw, t(b), t(ext),
                                             _z(ths, tw, t(b)), t(g))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, r in zip(("dhs", "dW", "db"), grads, ref_grads):
        a = a.float().numpy()
        a = a.T if name == "dW" else a
        assert a.shape == r.shape, name
        err = np.abs(a - r).max() / np.abs(r).max()
        assert err <= tol, f"{name}: {err:.3e}"


def test_bf16_rounding_points_diverge_from_the_reference():
    """Reference-side divergence (ROADMAP queue 3), at B 2, T 37, D 128, V
    77, S 128, seed 0, bf16. The Pallas kernel rounds the gathered logit
    to bf16 before subtracting z (ctc_head.py:62-66) and the cotangent g to
    bf16 before the scatter (:88-90); the port rounds neither.
      - emit: the port is off by at most the bf16 rounding of the gathered
        logit (2^-8 of it) and off on most entries, while the port's
        logits with that one rounding added match the reference on >= 99%
        of entries within 1e-5 (the rest: one bf16 unit, a rounding that
        fp32 summation order flipped).
      - backward: with the raw g the port differs by 1e-4 to 1e-2 of max
        |ref| per output (3.7e-3 dhs, 3.3e-3 dW, 1.7e-3 db at this seed),
        and with g exact in bf16 by under 1e-5: the whole difference is
        the rounding of g."""
    hs, w, b, ext, g = _inputs(seed=0)
    bf = jnp.bfloat16
    jhs, jw = jnp.asarray(hs, bf), jnp.asarray(w, bf)
    ths, tw = _as_port(jhs, jw, torch.bfloat16)
    ref, ref_grads = _pallas_vjp(jhs, jw, b, ext, g, V)

    lg = ths.float() @ tw.float().t() + t(b)
    z = torch.logsumexp(lg, -1, keepdim=True)
    gathered = lg.gather(2, t(ext).long()[:, None, :].expand(B, T, -1))
    port = kh.fused_ctc_head_emit_plain(ths, tw, t(b), t(ext)).numpy()
    rounded = (gathered.to(torch.bfloat16).float() - z).numpy()
    off = np.abs(port - ref)
    assert (off <= 2.0 ** -8 * np.abs(gathered.numpy()) + 1e-5).all()
    assert (off > 1e-5).mean() > 0.5
    assert (np.abs(rounded - ref) <= 1e-5).mean() >= 0.99

    zz = z[..., 0]
    for cot, lo, hi in ((g, 1e-4, 1e-2), (_bf16_exact(g), 0.0, 1e-5)):
        if lo == 0.0:
            ref_grads = _pallas_vjp(jhs, jw, b, ext, cot, V)[1]
        out = kh.fused_ctc_head_emit_bwd_plain(ths, tw, t(b), t(ext), zz,
                                               t(cot))
        for name, a, r in zip(("dhs", "dW", "db"), out, ref_grads):
            a = a.float().numpy()
            a = a.T if name == "dW" else a
            err = np.abs(a - r).max() / np.abs(r).max()
            assert lo <= err <= hi, f"{name}: {err:.3e} not in [{lo}, {hi}]"
