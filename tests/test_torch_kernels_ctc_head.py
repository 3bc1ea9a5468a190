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


def _inputs(seed=0, t_len=T, v=V):
    rng = np.random.RandomState(seed)
    hs = (rng.randn(B, t_len, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, v) * 0.1).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    ext = rng.randint(0, v, size=(B, SP)).astype(np.int32)
    ext[:, 5] = ext[:, 3]  # duplicates must add in the scatter
    ext[:, 0] = 0
    ext[:, 2] = 0
    g = rng.randn(B, t_len, SP).astype(np.float32)
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
