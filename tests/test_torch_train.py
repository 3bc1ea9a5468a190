"""The port's training path against the reference, on the tiny flagship.

espnet_slurp_tpu_torch/models/asr_model.py:ASRModel.forward (CTC through
the fused head and the lattice, label-smoothed CE on the decoder),
train/optim.py and train/state.py against their JAX counterparts, SpecAug
off and dropout 0 on both sides, fp32 on the CPU (the kernels' plain
versions), the same seeded inputs and the same weights (flax init,
converted by flax_to_torch). Tolerance 1e-4 relative: the loss and its
stats to rtol 1e-4, each parameter gradient to 1e-4 of the largest
gradient entry of its tensor, floored at 1e-4 of the largest entry of all
gradients (the key projections' biases have gradient 0 in exact
arithmetic, a softmax being blind to a per-row constant, and hold only
rounding noise, ~1e-8), the schedules to rtol 1e-5, the
3-step loss and grad-norm trajectory to rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.asr_model import ASRConfig as JaxASRConfig
from espnet_slurp_tpu.models.transducer import \
    TransducerConfig as JaxTransducerConfig
from espnet_slurp_tpu.train import optim as joptim
from espnet_slurp_tpu.train import state as jstate
from espnet_slurp_tpu_torch.models.asr_model import (ASRConfig, ASRModel,
                                                      add_sos_eos,
                                                      label_smoothing_loss)
from espnet_slurp_tpu_torch.models.transducer import TransducerConfig
from espnet_slurp_tpu_torch.train import optim as toptim
from espnet_slurp_tpu_torch.train.state import (TrainState, make_eval_step,
                                                make_train_step)
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (t, tiny_jax_model, tiny_port_cfg, tiny_port_model,
                          waveforms)

OPT = dict(lr=1e-3, scheduler="warmuplr", warmup_steps=10, grad_clip=5.0)


@pytest.fixture(scope="module")
def case():
    jmodel, params = tiny_jax_model(specaug=None)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32)
    tlens = np.asarray([5, 3], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text, text_lengths=tlens)
    return jmodel, params, batch


def _port(params):
    return tiny_port_model(params, specaug=None)


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def test_forward_loss_and_stats_match(case):
    jmodel, params, batch = case
    ref_loss, ref_stats = jmodel.apply({"params": params}, train=True,
                                       **batch)
    loss, stats = _port(params)(**_tbatch(batch), train=True)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert set(stats) == set(ref_stats) == {"loss_ctc", "loss_att", "acc",
                                            "loss"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)


def test_every_parameter_gradient_matches(case):
    jmodel, params, batch = case
    ref = jax.grad(lambda p: jmodel.apply({"params": p}, train=True,
                                          **batch)[0])(params)
    ref = flax_to_torch(jax.tree.map(np.asarray, ref))
    model = _port(params)
    loss, _ = model(**_tbatch(batch), train=True)
    loss.backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = grads[name].grad
        assert g is not None and g.shape == r.shape, name
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((g - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_schedules_match():
    """Every schedule of the reference (cosine short of its end, where
    fp32 1 + cos(pi) is rounding noise: tests/test_torch_optim_family.py
    holds that corner); an unknown schedule or optimizer raises ValueError
    on both sides (every optimizer is ported:
    tests/test_torch_optim_family.py)."""
    for sched in ("constant", "warmuplr", "noam", "warmup_step",
                  "exponential", "cosine"):
        kw = dict(lr=2e-3, scheduler=sched, warmup_steps=25, d_model=256,
                  decay_steps=150 if sched == "cosine" else 60)
        js = joptim.build_schedule(joptim.OptimConfig(**kw))
        ts = toptim.build_schedule(toptim.OptimConfig(**kw))
        ref = np.asarray([float(js(i)) for i in range(100)])
        out = np.asarray([float(ts(i)) for i in range(100)])
        np.testing.assert_allclose(out, ref, rtol=1e-5, err_msg=sched)
    for kw in (dict(scheduler="warmup"), dict(name="lamb")):
        with pytest.raises(ValueError):
            joptim.build_optimizer(joptim.OptimConfig(**kw))
        with pytest.raises(ValueError):
            toptim.build_optimizer(toptim.OptimConfig(**kw))


def test_flat_adamw_update_matches_optax():
    """Optimizer.update on the flat gradient against the optax chain over
    two tensors: clipping active, weight decay, three updates (rtol 1e-5:
    one fp32 chain in another order)."""
    rng = np.random.RandomState(4)
    shapes = [(3, 5), (7,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(name="adamw", lr=1e-2, scheduler="warmuplr", warmup_steps=3,
              weight_decay=0.1, grad_clip=1.0)
    jtx = joptim.build_optimizer(joptim.OptimConfig(**kw))
    tx = toptim.build_optimizer(toptim.OptimConfig(**kw))
    jp, tp = [jnp.asarray(p) for p in params], [t(p) for p in params]
    jst, st = jtx.init(jp), tx.init(tp)
    for _ in range(3):
        grads = [rng.randn(*s).astype(np.float32) * 3.0 for s in shapes]
        jup, jst = jtx.update([jnp.asarray(g) for g in grads], jst, jp)
        jp = [p + u for p, u in zip(jp, jup)]
        g = toptim.flatten([t(x) for x in grads])
        up, st = tx.update(g, torch.linalg.vector_norm(g), st, tp)
        tp = [p + u.view_as(p) for p, u in
              zip(tp, up.split([p.numel() for p in tp]))]
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-7)
    assert int(st["step"]) == 3


def test_three_step_trajectory_matches(case):
    jmodel, params, batch = case
    jtx = joptim.build_optimizer(joptim.OptimConfig(**OPT))
    jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), jtx,
                                   jax.random.PRNGKey(0))
    jstep = jstate.make_train_step(jmodel, jtx, donate=False)
    model = _port(params)
    tx = toptim.build_optimizer(toptim.OptimConfig(**OPT))
    st = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    tb = _tbatch(batch)
    for i in range(3):
        jst, jstats = jstep(jst, batch)
        st, stats = step(st, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
        assert float(stats["skipped"]) == float(jstats["skipped"]) == 0.0
    assert int(st.step) == 3 and int(st.opt_state["step"]) == 3
    ev = make_eval_step(model)(st, tb)
    assert np.isfinite(float(ev["loss"]))


def test_non_finite_batch_changes_nothing(case):
    _, params, batch = case
    model = _port(params)
    tx = toptim.build_optimizer(toptim.OptimConfig(**OPT))
    step = make_train_step(model, tx, spike_factor=10.0)
    st = TrainState.create(model, tx, seed=0, guard=True)
    st, _ = step(st, _tbatch(batch))
    before = [p.detach().clone() for p in model.parameters()]
    opt_before = {k: v.clone() for k, v in st.opt_state.items()}
    ema_before = st.gnorm_ema.clone()
    bad = _tbatch(batch)
    bad["speech"] = bad["speech"].clone()
    bad["speech"][0, 100] = float("nan")
    st, stats = step(st, bad)
    assert float(stats["skipped"]) == 1.0 and int(st.step) == 2
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
    assert set(st.opt_state) == set(opt_before) == {"step", "mu", "nu"}
    for k, v in opt_before.items():
        assert torch.equal(st.opt_state[k], v), k
    assert torch.equal(st.gnorm_ema, ema_before)


def test_dropout_above_zero_raises_naming_the_next_slice(case):
    """Named for the refusal it pinned until the dropout kernels landed:
    the tiny flagship at dropout 0.1 now trains on the CPU (K2 and K3 by
    their plain versions with the Philox masks). Its loss is finite and
    differs from rate 0's, and every parameter that takes a gradient at
    rate 0 takes a finite one."""
    _, params, batch = case
    ref = _port(params)
    ref_loss, _ = ref(**_tbatch(batch), train=True)
    ref_loss.backward()
    model = tiny_port_model(params, specaug=None, dropout_rate=0.1)
    loss, _ = model(**_tbatch(batch), train=True,
                    generator=torch.Generator().manual_seed(0))
    loss.backward()
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert np.isfinite(loss) and loss != ref_loss
    for (name, p), (_, r) in zip(model.named_parameters(),
                                 ref.named_parameters()):
        assert (p.grad is None) == (r.grad is None), name
        if p.grad is not None:
            assert torch.isfinite(p.grad).all(), name


def test_add_sos_eos_and_label_smoothing_match():
    from espnet_slurp_tpu.models import asr_model as jam
    ys = np.asarray([[4, 5, 6], [7, 8, 0]], np.int32)
    yl = np.asarray([3, 2], np.int32)
    ref_in, ref_out = jam.add_sos_eos(jnp.asarray(ys), jnp.asarray(yl), 9, 9)
    ys_in, ys_out = add_sos_eos(t(ys).long(), t(yl), 9, 9)
    np.testing.assert_array_equal(ys_in.numpy(), np.asarray(ref_in))
    np.testing.assert_array_equal(ys_out.numpy(), np.asarray(ref_out))
    logits = np.random.RandomState(0).randn(2, 4, 10).astype(np.float32)
    rl, ra = jam.label_smoothing_loss(jnp.asarray(logits), ref_out, 0.1)
    loss, acc = label_smoothing_loss(t(logits), ys_out, 0.1)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(ra), rtol=1e-6)


def test_bf16_model_keeps_fp32_parameters(case):
    """Repair of the bf16-parameter fault: a bf16 model stores fp32
    parameters and casts them per op; its bf16 encode stays within 2e-2
    of max |ref| of the fp32 encode with the same weights."""
    _, params, batch = case
    state = flax_to_torch(params)
    enc = {}
    for dtype in ("float32", "bfloat16"):
        model = ASRModel(tiny_port_cfg(dtype=dtype), device="cpu")
        model.load_state_dict(state)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        with torch.no_grad():
            hs, hl = model.encode(t(batch["speech"]),
                                  t(batch["speech_lengths"]))
        enc[dtype] = (hs, hl)
    (ref, hl), (out, hl16) = enc["float32"], enc["bfloat16"]
    assert out.dtype == torch.bfloat16 and torch.equal(hl, hl16)
    err = float((out.float() - ref).abs().max() / ref.abs().max())
    assert err <= 2e-2, err


def test_spike_skip_keeps_state_after_warm_up(case):
    """Past step 20 a grad norm above spike_factor x the accepted-step EMA
    is skipped whole (reference train/state.py:121-141): parameters,
    moments and the EMA stay; the step counter moves."""
    _, params, batch = case
    model = _port(params)
    tx = toptim.build_optimizer(toptim.OptimConfig(**OPT))
    step = make_train_step(model, tx, spike_factor=10.0)
    st = TrainState.create(model, tx, seed=0, guard=True)
    st.step.fill_(21)
    st.gnorm_ema.fill_(1e-3)  # any real gradient is a spike against this
    before = [p.detach().clone() for p in model.parameters()]
    st, stats = step(st, _tbatch(batch))
    assert float(stats["skipped"]) == float(stats["spike_skipped"]) == 1.0
    assert int(st.step) == 22 and int(st.opt_state["step"]) == 0
    assert float(st.gnorm_ema) == pytest.approx(1e-3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))


def test_ema_shadow_and_gradient_noise(case):
    """The EMA shadow follows decay * shadow + (1 - decay) * params, and
    eval reads it; gradient noise is drawn from the state's generator
    (the same seed gives the same step, noise changes it)."""
    _, params, batch = case
    tb = _tbatch(batch)
    runs = {}
    for name, kw in (("plain", {}), ("noise", dict(grad_noise_eta=1.0)),
                     ("noise_again", dict(grad_noise_eta=1.0))):
        model = _port(params)
        tx = toptim.build_optimizer(toptim.OptimConfig(**OPT))
        st = TrainState.create(model, tx, seed=3, ema=True)
        shadow0 = [e.clone() for e in st.ema_params]
        st, stats = make_train_step(model, tx, ema_decay=0.5, **kw)(st, tb)
        runs[name] = float(stats["grad_norm"])
        for e, e0, p in zip(st.ema_params, shadow0, model.parameters()):
            torch.testing.assert_close(e, 0.5 * e0 + 0.5 * p.detach())
        ev = make_eval_step(model)(st, tb)
        assert np.isfinite(float(ev["loss"]))
    assert runs["noise"] == runs["noise_again"] != runs["plain"]


def _shared_fields(port, ref, path=""):
    """(name, port value, reference value) of every field the two config
    dataclasses both have, nested configs walked."""
    ref_names = {f.name for f in dataclasses.fields(ref)}
    out = []
    for f in dataclasses.fields(port):
        if f.name not in ref_names:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
            out += _shared_fields(a, b, f"{path}{f.name}.")
        else:
            out.append((path + f.name, a, b))
    return out


@pytest.mark.parametrize("port,ref,pinned", [
    (ASRConfig, JaxASRConfig, ""),
    (TransducerConfig, JaxTransducerConfig, "asr.")])
def test_default_configs_equal_the_references(port, ref, pinned):
    """ASRConfig() and TransducerConfig() (the path that trains the default
    configuration: fp32, dropout 0.1, kernels on "auto", 12 x 256, 4 heads,
    d_ff 2048, a 6-block decoder, SpecAug on) equal the reference's
    defaults in every field both have, nested configs included."""
    shared = _shared_fields(port(), ref())
    names = {n for n, _, _ in shared}
    assert {pinned + k for k in (
        "dtype", "dropout_rate", "flash_attention", "n_head", "d_ff",
        "d_model", "num_encoder_blocks", "num_decoder_blocks",
        "decoder_d_ff", "vocab_size", "kernel_size", "ctc_weight",
        "lsm_weight", "use_mvn", "frontend.n_mels",
        "specaug.num_time_mask")} <= names
    for name, a, b in shared:
        assert a == b, f"{name}: port {a!r}, reference {b!r}"
