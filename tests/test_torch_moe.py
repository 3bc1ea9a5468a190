"""The routed MoE feed-forward of the port against the reference's.

espnet_slurp_tpu_torch/models/moe.py:MoEFeedForward (by index: a gather
into [E, C, D] buffers, batched expert products, a gather back) against
espnet_slurp_tpu/models/moe.py:MoEFeedForward (the one-hot [S, E, C]
einsum), fp32 on the CPU, B 2, T 12, D 16, F 32, E 4, with a pad mask, at
capacity factors 1.25 and 0.5 (tokens dropped at both: the seeded router
is lopsided). The inputs are seeded so that every valid token's top two
gates differ by more than 1e-4 (asserted), so fp32 rounding cannot send a
token to another expert: the expert of every token and the kept count of
every expert are held exactly; the output, the aux loss and every
gradient (input, router, experts) within 1e-5 (absolute and relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.moe import MoEFeedForward as JaxMoE
from espnet_slurp_tpu_torch.models.moe import MoEFeedForward
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t

B, T, D, F, E = 2, 12, 16, 32, 4
TOL = 1e-5
MARGIN = 1e-4


def _case(capacity, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.asarray([T, 7])
    pad = np.arange(T)[None, :] < lens[:, None]
    jm = JaxMoE(D, F, E, capacity)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), x, pad_mask=pad)["params"])
    # A lopsided router, so that experts overflow at both capacities.
    params["router"]["bias"] = np.asarray([0.9, 0.3, 0.0, -0.4], np.float32)
    port = MoEFeedForward(D, F, E, capacity)
    port.load_state_dict(flax_to_torch(params))
    return jm, params, port, x, pad


def _reference_routing(jm, params, x, pad):
    """(expert [S], kept count [E]) of the reference's routing, from its
    router's logits (captured) and its own rules, with the top-two gate
    margin of every valid token."""
    _, state = jm.apply({"params": params}, x, pad_mask=pad,
                        capture_intermediates=True)
    logits = state["intermediates"]["router"]["__call__"][0]
    gates = np.asarray(jax.nn.softmax(logits, axis=-1))
    expert = np.asarray(jnp.argmax(gates, axis=-1))
    valid = pad.reshape(-1)
    top2 = np.sort(gates, axis=-1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0])[valid].min()
    cap = max(int(B * T / E * jm.capacity_factor), 1)
    counts = np.bincount(expert[valid], minlength=E)
    return expert, np.minimum(counts, cap), counts, margin


@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_routing_equals_the_references(capacity):
    jm, params, port, x, pad = _case(capacity)
    expert, kept, counts, margin = _reference_routing(jm, params, x, pad)
    assert margin > MARGIN
    assert (counts > kept).any()  # tokens are dropped
    with torch.no_grad():
        _, got, pos, keep, _ = port.route(t(x), t(pad))
    valid = pad.reshape(-1)
    np.testing.assert_array_equal(got.numpy()[valid], expert[valid])
    got_kept = np.bincount(got.numpy()[keep.numpy()], minlength=E)
    np.testing.assert_array_equal(got_kept, kept)
    assert (pos.numpy()[~valid] == -1).all()
    assert not keep.numpy()[~valid].any()


@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_output_aux_and_every_gradient_match(capacity):
    jm, params, port, x, pad = _case(capacity)
    rng = np.random.RandomState(9)
    cot = rng.randn(B, T, D).astype(np.float32)
    w_aux = 0.7

    def objective(p, xx):
        y, aux = jm.apply({"params": p}, xx, pad_mask=pad)
        return jnp.sum(y * cot) + w_aux * aux, (y, aux)

    (_, (y_ref, aux_ref)), (g_p, g_x) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(params, x)
    xt = t(x).requires_grad_(True)
    y, aux = port(xt, t(pad))
    ((y * t(cot)).sum() + w_aux * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), atol=TOL,
                               rtol=TOL)
    assert not np.asarray(y_ref).reshape(-1, D)[~pad.reshape(-1)].any()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=TOL,
                               rtol=TOL)
    ref = flax_to_torch(jax.tree.map(np.asarray, g_p))
    grads = dict(port.named_parameters())
    assert set(grads) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), r.numpy(),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_no_tensor_of_tokens_by_experts_by_slots():
    """No tensor that the forward saves for the backward has S x E x C
    elements or more (B 4, T 64, D 8, F 8: S E C = 81,920 against the
    largest the layer needs, E C D = 2,560): the layer computes by index."""
    b, tt, d, f = 4, 64, 8, 8
    port = MoEFeedForward(d, f, E, 1.25)
    s, cap = b * tt, port.capacity(b * tt)
    x = torch.randn(b, tt, d, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    pad = torch.arange(tt)[None, :] < torch.tensor([[64], [50], [33], [9]])
    sizes = []

    def pack(tensor):
        sizes.append(tensor.numel())
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda v: v):
        y, aux = port(x, pad)
    (y.sum() + aux).backward()
    assert sizes and max(sizes) < s * E * cap
