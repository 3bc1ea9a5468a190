"""Kernel K5 (RNN-T lattice) and the port's RNN-T loss against the JAX
package, on the CPU.

espnet_slurp_tpu_torch/ops/kernels/transducer.py:rnnt_lattice runs its plain
version on CPU tensors; through ops/transducer.py:rnnt_loss_from_logprobs it
is held to the reference's anti-diagonal scan (espnet_slurp_tpu/ops/
transducer.py) and to its Pallas kernel rnnt_lattice_pallas in interpret
mode (as tests/test_pallas_transducer.py calls it: tables padded to 128
lanes). The same seeded log-probs go to both sides; the loss must agree to
rtol/atol 1e-4 and the gradient of a weighted loss sum w.r.t. the log-probs
to atol 1e-4, rtol 1e-3 (fp32 against the port's fp64 recursion).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import espnet_slurp_tpu.ops.transducer as jtr
from espnet_slurp_tpu.ops.pallas.transducer import rnnt_lattice_pallas
from espnet_slurp_tpu_torch.ops import transducer as ttr
from espnet_slurp_tpu_torch.ops.kernels.transducer import (rnnt_lattice,
                                                          rnnt_lattice_plain)
import torch_parity  # noqa: F401  (each test worker's CPU threads)

NEG = jtr.NEG_INF


def _case(seed, b, t, u, v, tlens=None, ulens=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, u + 1, v).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.randint(1, v, size=(b, u)).astype(np.int32)
    if tlens is None:
        tlens = rng.randint(t // 2, t + 1, size=(b,))
    if ulens is None:
        ulens = rng.randint(1, u + 1, size=(b,))
    w = rng.randn(b).astype(np.float32)
    return (log_probs, labels, np.asarray(tlens, np.int32),
            np.asarray(ulens, np.int32), w)


def _pallas_loss(log_probs, labels, tlens, ulens):
    """The reference dispatcher's TPU path, built here so that the kernel
    runs in interpret mode on the CPU."""
    b, t, u1, v = log_probs.shape
    blank_lp = log_probs[..., 0]
    lbl = jnp.minimum(labels, v - 1)
    emit_lp = jnp.take_along_axis(log_probs[:, :, :u1 - 1, :],
                                  lbl[:, None, :, None], axis=3)[..., 0]
    emit_lp = jnp.pad(emit_lp, ((0, 0), (0, 0), (0, 1)), constant_values=NEG)
    pad = ((0, 0), (0, 0), (0, -(-u1 // 128) * 128 - u1))
    loss = rnnt_lattice_pallas(
        jnp.pad(blank_lp, pad, constant_values=NEG),
        jnp.pad(emit_lp, pad, constant_values=NEG), tlens, ulens)
    feasible = (ulens <= u1 - 1) & (tlens >= 1)
    return jnp.where(feasible, loss, 0.0)


def _jax(fn, log_probs, labels, tlens, ulens, w):
    args = [jnp.asarray(x) for x in (labels, tlens, ulens)]

    def f(lp):
        loss = fn(lp, *args)
        return jnp.sum(loss * jnp.asarray(w)), loss

    (_, loss), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(log_probs))
    return np.asarray(loss), np.asarray(grad)


def _port(log_probs, labels, tlens, ulens, w):
    lp = torch.from_numpy(np.array(log_probs)).requires_grad_(True)
    loss = ttr.rnnt_loss_from_logprobs(lp, torch.from_numpy(labels),
                                       torch.from_numpy(tlens),
                                       torch.from_numpy(ulens))
    (loss * torch.from_numpy(w)).sum().backward()
    return loss.detach().numpy(), lp.grad.numpy()


def _hold(case, pallas=True):
    loss, grad = _port(*case)
    refs = [("scan", jtr.rnnt_loss_from_logprobs)]
    if pallas:
        refs.append(("pallas", _pallas_loss))
    for name, fn in refs:
        ref_loss, ref_grad = _jax(fn, *case)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(grad, ref_grad, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    return loss, grad


@pytest.mark.parametrize("seed,b,t,u,v,tlens,ulens", [
    (0, 4, 11, 6, 9, None, None),            # ragged lengths
    (1, 2, 7, 4, 6, (7, 7), (4, 4)),         # full lengths
    (2, 2, 20, 70, 6, (20, 15), (70, 41)),   # U + 1 = 71 crosses a warp
    (3, 3, 9, 5, 7, (9, 4, 6), (0, 5, 0)),   # rows without labels
])
def test_loss_and_gradient_match_scan_and_pallas(seed, b, t, u, v, tlens,
                                                 ulens):
    _hold(_case(seed, b, t, u, v, tlens, ulens))


def test_infeasible_rows_give_zero_loss_and_gradient():
    """ulen > U and tlen = 0 rows: loss 0 and gradient 0 on both sides; the
    lattice itself never reads alpha[-1] (its own rule: no frame, loss 0)."""
    case = _case(4, 3, 8, 4, 6, tlens=(8, 0, 6), ulens=(3, 2, 5))
    loss, grad = _hold(case, pallas=False)
    assert loss[1] == loss[2] == 0.0
    assert not grad[1:].any()
    assert grad[0].any()
    blank = torch.randn(1, 4, 3)
    out = rnnt_lattice(blank.clone().requires_grad_(True), blank,
                       torch.tensor([0], dtype=torch.int32),
                       torch.tensor([1], dtype=torch.int32))
    assert float(out.detach()) == 0.0


def test_labels_past_ulen_do_not_matter():
    """The caller does not NEG-mask emit at u >= ulen (the reference's
    docstring says it is): paths never move down in u, so garbage labels
    past each row's length change neither the loss nor the gradient."""
    lp, labels, tlens, ulens, w = _case(5, 3, 10, 6, 8, ulens=(2, 6, 0))
    dirty = labels.copy()
    for i, n in enumerate(ulens):
        dirty[i, n:] = np.random.RandomState(i).randint(0, 8, 6 - n)
    loss, grad = _port(lp, labels, tlens, ulens, w)
    loss_d, grad_d = _port(lp, dirty, tlens, ulens, w)
    np.testing.assert_array_equal(loss_d, loss)
    np.testing.assert_array_equal(grad_d, grad)
    ref_loss, _ = _jax(jtr.rnnt_loss_from_logprobs, lp, dirty, tlens, ulens, w)
    np.testing.assert_allclose(loss_d, ref_loss, rtol=1e-4, atol=1e-4)


def test_plain_lattice_is_the_alpha_recursion():
    """rnnt_lattice_plain against a direct double loop over (t, u) in numpy
    (fp64), on random tables with ragged lengths."""
    rng = np.random.RandomState(6)
    b, t, u1 = 3, 6, 5
    blank = -rng.rand(b, t, u1).astype(np.float32) * 3
    emit = -rng.rand(b, t, u1).astype(np.float32) * 3
    tlens, ulens = np.asarray([6, 3, 1], np.int32), np.asarray([4, 2, 0],
                                                               np.int32)
    out = rnnt_lattice_plain(torch.from_numpy(blank), torch.from_numpy(emit),
                             torch.from_numpy(tlens), torch.from_numpy(ulens))
    for i in range(b):
        al = np.full((t, u1), -np.inf)
        al[0, 0] = 0.0
        for tt in range(t):
            for uu in range(u1):
                c = []
                if tt > 0:
                    c.append(al[tt - 1, uu] + blank[i, tt - 1, uu])
                if uu > 0:
                    c.append(al[tt, uu - 1] + emit[i, tt, uu - 1])
                if c:
                    al[tt, uu] = np.logaddexp.reduce(c)
        tl, ul = tlens[i], ulens[i]
        ref = -(al[tl - 1, ul] + blank[i, tl - 1, ul])
        np.testing.assert_allclose(float(out[i]), ref, rtol=1e-6)


def test_plain_lattice_at_the_train_shape_matches_the_reference_scan():
    """rnnt_lattice_plain at the transducer train step's lattice (T' 468,
    U1 65; two rows, ragged: tlen 468 / 401, ulen 64 / 47) against the
    reference's anti-diagonal scan (espnet_slurp_tpu/ops/transducer.py) on
    the same seeded tables: the loss, and the gradients of a weighted loss
    sum w.r.t. both tables. The reference takes [B, T, U1, V] log-probs, so
    its input stacks the tables as V 2 with every label 1: log_probs[..., 0]
    is the blank table, log_probs[..., 1] at u < U the emit table (it pads
    emit's last column with NEG itself, as the port's caller does).
    Tolerances: the loss (~1e3 in magnitude) to rtol 1e-5, the scan
    accumulating fp32 rounding over 532 steps; the gradients (posteriors
    times the weights, max |ref| ~1) to atol 1e-4, rtol 1e-3, as in the
    tests above (fp32 autodiff of the scan against the port's fp64
    recursion)."""
    rng = np.random.RandomState(7)
    b, t, u1, v = 2, 468, 65, 8
    logits = rng.randn(b, t, u1, v).astype(np.float32) * 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    blank, emit = lp[..., 0].copy(), lp[..., 1].copy()
    emit[..., -1] = NEG
    tlens = np.asarray([468, 401], np.int32)
    ulens = np.asarray([64, 47], np.int32)
    w = rng.rand(b).astype(np.float32) + 0.5

    def ref(tables):
        loss = jtr.rnnt_loss_from_logprobs(
            tables, jnp.ones((b, u1 - 1), jnp.int32), jnp.asarray(tlens),
            jnp.asarray(ulens))
        return jnp.sum(loss * jnp.asarray(w)), loss

    (_, ref_loss), ref_g = jax.jit(jax.value_and_grad(ref, has_aux=True))(
        jnp.asarray(np.stack([blank, emit], -1)))
    ref_g = np.asarray(ref_g)

    tb = torch.from_numpy(blank).requires_grad_(True)
    te = torch.from_numpy(emit).requires_grad_(True)
    loss = rnnt_lattice_plain(tb, te, torch.from_numpy(tlens),
                              torch.from_numpy(ulens))
    (loss * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), ref_g[..., 0], rtol=1e-3,
                               atol=1e-4)
    # emit's last column is the pad: the reference's gradient does not
    # reach it, and the port's is an exact zero (its entries are NEG).
    np.testing.assert_allclose(te.grad.numpy()[..., :-1],
                               ref_g[..., :-1, 1], rtol=1e-3, atol=1e-4)
    assert not te.grad.numpy()[..., -1].any()
    assert np.abs(ref_g[..., 0]).max() > 0.1
