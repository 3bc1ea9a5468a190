"""Kernel K1 (CTC lattice) and the port's ops/ctc.py against the reference.

espnet_slurp_tpu_torch/ops/kernels/ctc.py on CPU tensors runs
ctc_lattice_plain (gradient by autograd); through ops/ctc.py:ctc_loss it is
held to the Pallas kernel's ctc_loss_pallas in interpret mode, loss and
gradient with respect to the log-probs, with repeated labels, an infeasible
row (loss 0, grad 0) and a ragged B = 3. ops/ctc.py (ctc_loss,
ctc_loss_logits, ctc_loss_mean_logits) is held to the JAX scan versions and
to torch.nn.functional.ctc_loss (zero_infinity=True). Tolerances as in
tests/test_pallas_ctc.py: loss rtol 1e-4, gradients atol 2e-4 (fp32).

The one documented divergence (ROADMAP.md queue 3): for an empty label
sequence the reference kernel counts the final state twice (loss log 2 too
small); the port follows the reference scan and F.ctc_loss.

ctc_lattice_plain, which the card's two routes (one warp per utterance up
to 256 states, one block past it) are held to, is also held to the Pallas
lattice itself (_ctc_core, interpret mode) at the routes' edges: S 1, 3,
256 and 257, tlen 0, 1 and T, every skip off, last 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from espnet_slurp_tpu.ops import ctc as jctc
from espnet_slurp_tpu.ops.pallas.ctc import _ctc_core as jax_lattice
from espnet_slurp_tpu.ops.pallas.ctc import ctc_loss_pallas as jax_pallas
from espnet_slurp_tpu_torch.ops import ctc as tctc
from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
from torch_parity import t


def _case(seed=0, b=3, t_len=20, v=10, u=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t_len, v).astype(np.float32)
    labels = rng.randint(1, v, size=(b, u)).astype(np.int32)
    labels[0, 2] = labels[0, 1]  # adjacent repeat
    ilens = np.asarray([t_len, t_len - 5, 4][:b], np.int32)
    olens = np.asarray([u, u - 2, u][:b], np.int32)  # row 2: U > T
    return logits, ilens, labels, olens


def _jax_loss_and_grad(fn, logits, ilens, labels, olens):
    def f(lg):
        return fn(jax.nn.log_softmax(lg, -1), jnp.asarray(ilens),
                  jnp.asarray(labels), jnp.asarray(olens))
    loss = f(jnp.asarray(logits))
    grad = jax.grad(lambda lg: f(lg).sum())(jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


def _port_loss_and_grad(fn, logits, ilens, labels, olens):
    lg = t(logits).requires_grad_(True)
    loss = fn(torch.log_softmax(lg, -1), t(ilens), t(labels), t(olens))
    loss.sum().backward()
    return loss.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_lattice_matches_pallas_interpret(seed):
    case = _case(seed)
    ref_l, ref_g = _jax_loss_and_grad(jax_pallas, *case)
    loss, grad = _port_loss_and_grad(tctc.ctc_loss, *case)
    np.testing.assert_allclose(loss, ref_l, rtol=1e-4)
    np.testing.assert_allclose(grad, ref_g, atol=2e-4)
    assert loss[2] == 0.0 and np.all(grad[2] == 0.0)  # infeasible row


@pytest.mark.parametrize("s", [1, 3, 256, 257])
def test_plain_lattice_matches_pallas_at_the_kernel_edges(s):
    """ctc_lattice_plain against the Pallas lattice (_ctc_core, interpret
    mode; its caller's padding of S to 128 lanes with NEG emissions and no
    skips) on [4, T, S] emissions at S 1 and 3 (one lane's states), 256
    (the warp route's limit) and 257 (the block route): row 0 every skip
    allowed over T = S / 2 + 8 frames, row 1 tlen 0, row 2 tlen 1 with
    empty labels (last 0), row 3 every skip off (repeated labels) over T -
    2 frames. Loss rtol 1e-4, gradient atol 2e-4, as the file's other
    cases; a row whose likelihood saturates gets cotangent 0, as
    zero_infinity gives it. Rows with last 0 keep the documented
    divergence: the reference counts the final state twice, so its loss is
    log 2 smaller and its gradient half."""
    rng = np.random.RandomState(s)
    b, t_len = 4, s // 2 + 8
    lp = np.log(rng.dirichlet(np.ones(7), size=(b, t_len)))
    idx = rng.randint(0, 7, size=(b, s))
    emit = np.take_along_axis(lp, np.broadcast_to(idx[:, None, :],
                                                  (b, t_len, s)), 2)
    emit = emit.astype(np.float32)
    skip = np.ones((b, s), np.float32)
    skip[2:] = 0.0
    tlen = np.asarray([t_len, 0, 1, t_len - 2], np.int32)
    last = np.asarray([s - 1, min(s - 1, 2), 0,
                       min(s - 1, t_len - 3) // 2 * 2], np.int32)
    g = rng.rand(b).astype(np.float32)

    e = t(emit).requires_grad_(True)
    loss = kctc.ctc_lattice(e, t(skip), t(tlen), t(last))
    g = np.where(loss.detach().numpy() < 1e29, g, 0.0).astype(np.float32)
    (grad,) = torch.autograd.grad(loss, e, t(g))

    sp = -(-s // 128) * 128
    pe = np.full((b, t_len, sp), kctc.NEG, np.float32)
    pe[..., :s] = emit
    ps = np.zeros((b, sp), np.float32)
    ps[:, :s] = skip
    ref, vjp = jax.vjp(lambda x: jax_lattice(x, jnp.asarray(ps),
                                             jnp.asarray(tlen),
                                             jnp.asarray(last)),
                       jnp.asarray(pe))
    ref_g = np.asarray(vjp(jnp.asarray(g))[0])
    assert (ref_g[..., s:] == 0).all()
    ref, ref_g = np.asarray(ref), ref_g[..., :s]
    empty = last == 0
    ref = np.where(empty, ref + np.log(2.0), ref)
    ref_g = np.where(empty[:, None, None], 2.0 * ref_g, ref_g)
    assert (loss.detach().numpy()[[0, 2]] < 1e29).all()
    np.testing.assert_allclose(loss.detach().numpy(), ref, rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), ref_g, atol=2e-4)
    assert np.all(grad.numpy()[1] == 0.0)  # tlen 0
    assert np.all(grad.numpy()[2, 1:] == 0.0)  # past tlen 1


def test_wrapper_on_cpu_is_plain_and_not_counted():
    rng = np.random.RandomState(5)
    emit = t(np.log(rng.dirichlet(np.ones(7), size=(2, 9)))[..., :7]
             .astype(np.float32))
    skip = t((rng.rand(2, 7) > 0.5).astype(np.float32))
    tlen, last = t(np.asarray([9, 6], np.int32)), t(np.asarray([6, 4],
                                                               np.int32))
    before = (kctc.ctc_lattice.launches, kctc.ctc_lattice.bwd_launches)
    out = kctc.ctc_lattice(emit, skip, tlen, last)
    assert (kctc.ctc_lattice.launches, kctc.ctc_lattice.bwd_launches) \
        == before
    torch.testing.assert_close(
        out, kctc.ctc_lattice_plain(emit, skip, tlen, last), atol=0, rtol=0)
    with pytest.raises(ValueError):
        kctc.ctc_lattice(emit, skip, tlen.long(), last)
    with pytest.raises(TypeError):
        kctc.ctc_lattice(emit.double(), skip, tlen, last)


@pytest.mark.parametrize("entry", ["ctc_loss", "ctc_loss_logits"])
def test_ops_ctc_matches_jax_scan(entry):
    logits, ilens, labels, olens = _case(3)
    jfn, tfn = getattr(jctc, entry), getattr(tctc, entry)
    x = jnp.asarray(logits)
    if entry == "ctc_loss":
        jf = lambda lg: jfn(jax.nn.log_softmax(lg, -1), ilens, labels, olens)
        tf = lambda lg: tfn(torch.log_softmax(lg, -1), t(ilens), t(labels),
                            t(olens))
    else:
        jf = lambda lg: jfn(lg, ilens, labels, olens)
        tf = lambda lg: tfn(lg, t(ilens), t(labels), t(olens))
    ref_l = np.asarray(jf(x))
    ref_g = np.asarray(jax.grad(lambda lg: jf(lg).sum())(x))
    lg = t(logits).requires_grad_(True)
    loss = tf(lg)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref_l, rtol=1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), ref_g, atol=2e-4)


def test_mean_logits_matches_jax():
    logits, ilens, labels, olens = _case(4)
    ref = jctc.ctc_loss_mean_logits(jnp.asarray(logits), ilens, labels,
                                    olens)
    out = tctc.ctc_loss_mean_logits(t(logits), t(ilens), t(labels),
                                    t(olens))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


def test_matches_torch_ctc_loss_zero_infinity():
    logits, ilens, labels, olens = _case(6)
    lg = t(logits).requires_grad_(True)
    lp = torch.log_softmax(lg, -1)
    ours = tctc.ctc_loss(lp, t(ilens), t(labels), t(olens))
    ours.sum().backward()
    g_ours = lg.grad.clone()
    lg.grad = None
    lp = torch.log_softmax(lg, -1)
    ref = F.ctc_loss(lp.transpose(0, 1), t(labels).long(), t(ilens).long(),
                     t(olens).long(), blank=0, reduction="none",
                     zero_infinity=True)
    ref.sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(g_ours.numpy(), lg.grad.numpy(), atol=2e-4)


def test_empty_labels_follow_the_scan_not_the_kernel():
    rng = np.random.RandomState(7)
    logits = rng.randn(2, 6, 5).astype(np.float32)
    labels = np.asarray([[0, 0], [3, 1]], np.int32)
    ilens = np.asarray([6, 5], np.int32)
    olens = np.asarray([0, 2], np.int32)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    scan = np.asarray(jctc.ctc_loss(lp, ilens, labels, olens))
    pallas = np.asarray(jax_pallas(lp, ilens, labels, olens))
    ours = tctc.ctc_loss(torch.log_softmax(t(logits), -1), t(ilens),
                         t(labels), t(olens)).numpy()
    np.testing.assert_allclose(ours, scan, rtol=1e-4)
    np.testing.assert_allclose(pallas[0], scan[0] - np.log(2.0), rtol=1e-4)
    ref = F.ctc_loss(torch.log_softmax(t(logits), -1).transpose(0, 1),
                     t(labels).long(), t(ilens).long(), t(olens).long(),
                     reduction="none", zero_infinity=True)
    np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-4)
