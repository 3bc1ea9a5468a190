"""The port's language models (espnet_slurp_tpu_torch/models/lm.py) against
the reference's flax modules on the CPU, fp32, with the flax parameters
converted by utils/params.py:flax_to_torch (the LM tree loads strictly):
the Transformer and LSTM LMs' logits within 1e-5 of max |ref| and each
parameter gradient within 1e-5 of its max |ref| (floored at 1e-5 of the
largest gradient: the attention's key bias has a zero gradient in exact
arithmetic, so both sides give rounding noise there), ``step`` against the full forward and against the
reference's ``step`` (1e-5), ``step`` leaving its input cache unchanged,
and ``lm_loss``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import lm as jlm
from espnet_slurp_tpu_torch.models import lm as plm
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

WIDTHS = dict(vocab_size=30, d_model=16, n_head=2, d_ff=32, num_blocks=2,
              num_layers=2)
YS = np.array([[29, 5, 7, 2, 11, 3], [29, 4, 2, 8, 0, 0]])
LENS = np.array([6, 4])
TOL = 1e-5


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def _models(arch):
    jc = jlm.LMConfig(arch=arch, **WIDTHS)
    jm = jlm.TransformerLM(jc) if arch == "transformer" else jlm.LSTMLM(jc)
    params = jm.init(jax.random.PRNGKey(0), YS, LENS)["params"]
    params = jax.tree.map(np.asarray, params)
    pc = plm.LMConfig(arch=arch, **WIDTHS)
    pm = (plm.TransformerLM if arch == "transformer" else plm.LSTMLM)(
        pc, device="cpu")
    pm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("arch", ["transformer", "lstm"])
def test_forward_and_gradients_match(arch):
    jm, params, pm = _models(arch)
    cot = np.random.RandomState(1).randn(2, YS.shape[1],
                                         30).astype(np.float32)

    def f(p):
        out = jm.apply({"params": p}, YS, LENS)
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    out = pm(torch.from_numpy(YS), torch.from_numpy(LENS))
    assert _rel(out.detach().numpy(), ref) <= TOL
    (out * torch.from_numpy(cot)).sum().backward()
    want = flax_to_torch(jax.tree.map(np.asarray, grads))
    got = dict(pm.named_parameters())
    assert set(want) == set(got)
    floor = TOL * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        err = float((got[name].grad - g).abs().max())
        assert err <= max(TOL * float(g.abs().max()), floor), (name, err)


@pytest.mark.parametrize("arch", ["transformer", "lstm"])
def test_step_matches_the_full_forward_and_the_reference(arch):
    jm, params, pm = _models(arch)
    l = YS.shape[1]
    full = pm(torch.from_numpy(YS), torch.from_numpy(LENS)).detach().numpy()
    if arch == "transformer":
        jstate = jm.apply({"params": params},
                          method=lambda m: m.init_cache(2, l))
        pstate = pm.init_cache(2, l)
    else:
        jstate = jm.apply({"params": params},
                          method=lambda m: m.init_carry(2))
        pstate = pm.init_carry(2)
    jstep = jax.jit(lambda p, y, c: jm.apply(
        {"params": p}, y, c, method=lambda m, y, c: m.step(y, c)))
    for t in range(l):
        before = [x.clone() for x in _leaves(pstate)]
        with torch.no_grad():
            got, new = pm.step(torch.from_numpy(YS[:, t]), pstate)
        for x, y in zip(before, _leaves(pstate)):
            assert torch.equal(x, y), "step changed its input state"
        ref, jstate = jstep(params, YS[:, t], jstate)
        assert _rel(got.numpy(), ref) <= TOL, t
        for i in range(2):
            if t < LENS[i]:
                assert _rel(got[i].numpy(), full[i, t]) <= TOL, (i, t)
        pstate = new


def _leaves(state):
    if isinstance(state, dict):
        return [x for v in state.values() for x in _leaves(v)]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    return [state]


def test_lm_loss_matches():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    tgt = rng.randint(0, 11, (2, 5))
    lens = np.array([5, 3])
    ref = jlm.lm_loss(jnp.asarray(logits), jnp.asarray(tgt),
                      jnp.asarray(lens))
    got = plm.lm_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                      torch.from_numpy(lens))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)
    assert int(got[2]) == int(ref[2]) == 8
