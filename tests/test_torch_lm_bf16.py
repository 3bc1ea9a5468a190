"""The LSTM LM's decode carry at bf16 (ROADMAP.md queue 3, reference-side).

The reference's LSTMLM.init_carry (models/lm.py:115-118) makes the decode
carry in ``cfg.jax_dtype``, while its __call__ (nn.RNN) starts from flax's
fp32 carry: at ``dtype: bfloat16`` its fused decode steps a bf16 state
that training never saw. The port keeps c and h in fp32 both ways
(models/lm.py:LSTMLM.init_carry / step), as the transducer's prediction
network does (tests/test_torch_transducer.py::
test_bf16_prediction_steps_follow_the_training_path). Vocab 30, d_model
64, 2 layers, 24 tokens, 3 rows:

- the reference stepped from an fp32 zero carry reproduces its __call__
  exactly, so the carry's type is the whole of its gap; stepped from its
  own init_carry it strays (recorded: 3.7e-4 of a largest output of
  0.077);
- the port's steps from init_carry equal its own training forward bit for
  bit and are held to the reference's __call__ within 2e-3 abs, bf16
  rounding (torch and XLA order the bf16 gate sums differently, which
  moves outputs by about as much as the reference's carry gap).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from espnet_slurp_tpu.models import lm as jlm
from espnet_slurp_tpu_torch.models import lm as plm
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

WIDTHS = dict(arch="lstm", vocab_size=30, d_model=64, num_layers=2,
              dtype="bfloat16")


def test_bf16_lstm_lm_steps_follow_the_training_path():
    b, n = 3, 24
    ys = np.random.RandomState(0).randint(0, 30, (b, n)).astype(np.int32)
    lens = np.full((b,), n, np.int32)
    jm = jlm.LSTMLM(jlm.LMConfig(**WIDTHS))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), ys,
                                              lens)["params"])
    ref = np.asarray(jm.apply({"params": params}, ys, lens), np.float32)
    step = jax.jit(lambda y, c: jm.apply(
        {"params": params}, y, c, method=lambda m, y, c: m.step(y, c)))

    def ref_steps(carry):
        out = []
        for u in range(n):
            g, carry = step(jnp.asarray(ys[:, u]), carry)
            out.append(np.asarray(g, np.float32))
        return np.stack(out, 1)

    init = jm.apply({"params": params}, b,
                    method=lambda m, k: m.init_carry(k))
    assert init[0][0].dtype == jnp.bfloat16
    z = jnp.zeros((b, 64), jnp.float32)
    np.testing.assert_array_equal(ref_steps([(z, z), (z, z)]), ref)
    gap = float(np.abs(ref_steps(init) - ref).max())
    assert gap > 1e-4, gap  # recorded: 3.7e-4

    pm = plm.LSTMLM(plm.LMConfig(**WIDTHS), device="cpu")
    pm.load_state_dict(flax_to_torch(params))
    carry = pm.init_carry(b)
    assert all(x.dtype == torch.float32 for cr in carry for x in cr)
    outs = []
    with torch.no_grad():
        for u in range(n):
            g, carry = pm.step(torch.from_numpy(ys[:, u]).long(), carry)
            outs.append(g)
        full = pm(torch.from_numpy(ys).long(), torch.from_numpy(lens))
    steps = torch.stack(outs, 1)
    assert torch.equal(steps, full)
    err = float(np.abs(steps.float().numpy() - ref).max())
    assert err <= 2e-3, err  # recorded: 4.9e-4 of a largest 0.077
