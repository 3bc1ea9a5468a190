"""Every optimizer and schedule of the port against the reference's optax
chains, and ``accum_grad`` against optax.MultiSteps.

espnet_slurp_tpu_torch/train/optim.py (the flat-vector chain) against
espnet_slurp_tpu/train/optim.py: each optimizer (adam, adamw, sgd with and
without momentum, adadelta, adagrad, rmsprop) under each schedule
(constant, warmuplr, noam, warmup_step, exponential, cosine) over 5
updates of two tensors, with clipping active and, for adamw, weight decay;
the schedules over 120 steps on both sides of their corners. Then
accum_grad 3 (sgd with momentum, warmuplr) through both packages'
make_train_step on the tiny flagship,
over 7 steps of which the third is non-finite (a NaN in the waveform): the
skip rolls back the running mean and the mini-step count with the rest,
so both sides apply their updates on the same later steps. Tolerance: the
parameters to rtol 1e-4 (test_torch_train.py's), atol 1e-7; the
schedules to rtol 1e-5 (atol 1e-7 of lr, for cosine's fp32 1 + cos near
its end); the train-step losses and grad norms to rtol 1e-4,
each parameter to 1e-4 of its max |ref| (floored at 1e-6).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.train import optim as joptim
from espnet_slurp_tpu.train import state as jstate
from espnet_slurp_tpu_torch.train import optim as toptim
from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, tiny_jax_model, tiny_port_model, waveforms

RTOL, ATOL = 1e-4, 1e-7
OPTIMIZERS = {
    "adam": dict(name="adam"),
    "adamw": dict(name="adamw", weight_decay=0.1),
    "sgd": dict(name="sgd"),
    "sgd_momentum": dict(name="sgd", momentum=0.9),
    "adadelta": dict(name="adadelta", rho=0.9),
    "adagrad": dict(name="adagrad"),
    "rmsprop": dict(name="rmsprop"),
}
SCHEDULES = {
    "constant": dict(scheduler="constant"),
    "warmuplr": dict(scheduler="warmuplr", warmup_steps=3),
    "noam": dict(scheduler="noam", warmup_steps=3, d_model=64),
    "warmup_step": dict(scheduler="warmup_step", warmup_steps=2,
                        decay_steps=1, decay_rate=0.5),
    "exponential": dict(scheduler="exponential", decay_steps=2,
                        decay_rate=0.7),
    "cosine": dict(scheduler="cosine", decay_steps=4),
}


@pytest.mark.parametrize("opt,sched", list(itertools.product(
    sorted(OPTIMIZERS), sorted(SCHEDULES))))
def test_five_updates_match_optax(opt, sched):
    kw = dict(lr=0.05, grad_clip=2.0, **OPTIMIZERS[opt], **SCHEDULES[sched])
    rng = np.random.RandomState(sorted(OPTIMIZERS).index(opt))
    shapes = [(3, 5), (7,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jtx = joptim.build_optimizer(joptim.OptimConfig(**kw))
    tx = toptim.build_optimizer(toptim.OptimConfig(**kw))
    jp, tp = [jnp.asarray(p) for p in params], [t(p) for p in params]
    jst, st = jtx.init(jp), tx.init(tp)
    for i in range(5):
        # Norms around the clip: some updates are clipped, some are not.
        grads = [rng.randn(*s).astype(np.float32) * (0.2 + i * 0.3)
                 for s in shapes]
        jup, jst = jtx.update([jnp.asarray(g) for g in grads], jst, jp)
        jp = [p + u for p, u in zip(jp, jup)]
        g = toptim.flatten([t(x) for x in grads])
        up, st = tx.update(g, torch.linalg.vector_norm(g), st, tp)
        tp = [p + u.view_as(p) for p, u in
              zip(tp, up.split([p.numel() for p in tp]))]
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=ATOL, err_msg=f"update {i}")
    assert int(st["step"]) == 5


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedules_match_over_their_corners(sched):
    kw = dict(lr=2e-3, **SCHEDULES[sched])
    kw.update(warmup_steps=25, decay_steps=40)
    js = joptim.build_schedule(joptim.OptimConfig(**kw))
    ts = toptim.build_schedule(toptim.OptimConfig(**kw))
    ref = np.asarray([float(js(i)) for i in range(120)])
    out = np.asarray([float(ts(i)) for i in range(120)])
    # atol 1e-7 of lr: cosine's fp32 1 + cos(pi s / T) near s = T.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7 * kw["lr"])


def test_unknown_names_raise_as_the_reference():
    for kw in (dict(name="lamb"), dict(scheduler="warmup")):
        with pytest.raises(ValueError):
            joptim.build_optimizer(joptim.OptimConfig(**kw))
        with pytest.raises(ValueError):
            toptim.build_optimizer(toptim.OptimConfig(**kw))


def test_accumulation_without_a_train_step_matches_multisteps():
    """accum_grad 3 at the optimizer level: updates are zero on two
    mini-steps of three, the third applies the chain to the mean; Adam's
    count moves on applied updates only."""
    kw = dict(name="adam", lr=0.05, scheduler="warmuplr", warmup_steps=2,
              grad_clip=1.0, accum_grad=3)
    rng = np.random.RandomState(5)
    p0 = rng.randn(11).astype(np.float32)
    jtx = joptim.build_optimizer(joptim.OptimConfig(**kw))
    tx = toptim.build_optimizer(toptim.OptimConfig(**kw))
    jp, tp = jnp.asarray(p0), t(p0)
    jst, st = jtx.init(jp), tx.init([tp])
    for i in range(7):
        g = rng.randn(11).astype(np.float32)
        jup, jst = jtx.update(jnp.asarray(g), jst, jp)
        jp = jp + jup
        up, st = tx.update(t(g), torch.linalg.vector_norm(t(g)), st, [tp])
        tp = tp + up
        assert bool((up == 0).all()) == (i % 3 != 2)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                                   atol=ATOL, err_msg=f"mini-step {i}")
    assert (int(st["step"]), int(st["mini_step"])) == (2, 1)


def test_accum_grad_train_steps_roll_back_a_non_finite_mini_step():
    """sgd with momentum: Adam would turn the rounding noise of the key
    projections' biases (gradient 0 in exact arithmetic) into full-size
    updates, whose signs then differ between the packages."""
    opt = dict(name="sgd", momentum=0.9, lr=0.05, scheduler="warmuplr",
               warmup_steps=4, grad_clip=5.0, accum_grad=3)
    jmodel, params = tiny_jax_model(specaug=None)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text,
                 text_lengths=np.asarray([5, 3], np.int32))
    bad = dict(batch, speech=x.copy())
    bad["speech"][0, 100] = np.nan
    jtx = joptim.build_optimizer(joptim.OptimConfig(**opt))
    jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), jtx,
                                   jax.random.PRNGKey(0))
    jstep = jstate.make_train_step(jmodel, jtx, donate=False)
    model = tiny_port_model(params, specaug=None)
    tx = toptim.build_optimizer(toptim.OptimConfig(**opt))
    st = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    for i in range(7):
        b = bad if i == 2 else batch
        jst, jstats = jstep(jst, b)
        st, stats = step(st, {k: t(v) for k, v in b.items()})
        skipped = float(stats["skipped"])
        assert skipped == float(jstats["skipped"]) == (1.0 if i == 2
                                                       else 0.0)
        if not skipped:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(stats[k]),
                                           float(jstats[k]), rtol=RTOL,
                                           err_msg=f"step {i} {k}")
    # Six finite mini-steps: two applied updates, nothing pending.
    assert (int(st.opt_state["step"]), int(st.opt_state["mini_step"])) == (
        2, 0)
    ref = flax_to_torch(jax.tree.map(np.asarray, jst.params))
    got = dict(model.named_parameters())
    for name, r in ref.items():
        tol = max(1e-4 * float(r.abs().max()), 1e-6)
        err = float((got[name].detach() - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
