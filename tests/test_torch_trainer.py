"""The port's training runtime against the reference's: Reporter, checkpoints
(save, restore, prune, the n-best average), resume, the divergence guard
and the all-invalid abort (the cases of tests/test_divergence_guard.py),
the task configs' defaults, the unported options that raise, the
reference's parameter init, and global MVN through Speech2Text.

Tolerances: the Reporter's JSON and the configs are compared exactly; the
n-best average to the numpy float64 mean rounded to float32 exactly; a
resumed run to the uninterrupted one bit for bit (CPU); the guard's
decisions and the all-invalid abort to the reference Trainer's on the same
valid-loss tables exactly; the init's per
tensor mean and std to the reference's within 5 standard errors; the MVN
encode to the reference's within 1e-4 (fp32, stacked blocks)."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.ops.normalize import global_mvn_params as j_mvn_params
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.train import mbr as jmbr
from espnet_slurp_tpu.train import optim as joptim
from espnet_slurp_tpu.train import reporter as jrep
from espnet_slurp_tpu.train import trainer as jtrainer
from espnet_slurp_tpu_torch.models.asr_model import ASRModel
from espnet_slurp_tpu_torch.ops.normalize import global_mvn_params
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.train import optim as poptim
from espnet_slurp_tpu_torch.train import reporter as prep
from espnet_slurp_tpu_torch.train.checkpoint import (CKPT_FILE,
                                                     CheckpointManager)
from espnet_slurp_tpu_torch.train.state import TrainState
from espnet_slurp_tpu_torch.train.trainer import Trainer, TrainerOptions
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, waveforms

# ---------------------------------------------------------------------------
# Reporter
# ---------------------------------------------------------------------------


def test_reporter_json_and_means_match_the_reference(tmp_path):
    steps = [{"loss": 2.5, "acc": 0.25}, {"loss": 1.5, "acc": 0.5},
             {"loss": 0.5, "acc": None}]
    js, ps = jrep.SubReporter(), prep.SubReporter()
    for s in steps:
        js.register(s)
        # device-side stats stay tensors until mean()
        ps.register({k: (None if v is None else torch.tensor(v))
                     for k, v in s.items()})
        ps.register({"iter_time": 0.5}, weight=0.0)
    jm, pm = js.mean(), ps.mean()
    assert {k: v for k, v in pm.items() if k not in ("time_s", "steps",
                                                     "iter_time")} == \
        {k: v for k, v in jm.items() if k not in ("time_s", "steps")}
    jr, pr = jrep.Reporter(), prep.Reporter()
    for e, loss in ((1, 3.0), (2, 1.0), (3, 2.0)):
        for r in (jr, pr):
            r.observe(e, "train", {"loss": loss + 1, "steps": 4})
            r.observe(e, "valid", {"loss": loss})
    jr.save(tmp_path / "j.json")
    pr.save(tmp_path / "p.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    back = prep.Reporter.load(tmp_path / "j.json")
    assert back.history == jr.history
    assert back.sort_epochs("valid", "loss") == [2, 3, 1]
    assert back.best_epoch("valid", "loss") == 2
    assert back.check_early_stopping(0, "valid", "loss")
    assert not back.check_early_stopping(1, "valid", "loss")
    assert back.log_line(2) == jr.log_line(2)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(2))
        self.lin = nn.Linear(3, 2)


def _toy_state(guard=True, ema=False, seed=0):
    model = Toy()
    tx = poptim.build_optimizer(poptim.OptimConfig(scheduler="constant"))
    return model, TrainState.create(model, tx, seed=seed, ema=ema,
                                    guard=guard)


def test_checkpoint_round_trip_with_generator_and_guard_fields(tmp_path):
    model, state = _toy_state(ema=True)
    with torch.no_grad():
        model.w.copy_(torch.tensor([1.5, -2.0]))
    torch.rand(5, generator=state.generator)  # move the stream
    state = dataclasses.replace(
        state, step=torch.tensor(7), lr_scale=torch.tensor(0.25),
        gnorm_ema=torch.tensor(3.5),
        opt_state={k: v + 1 for k, v in state.opt_state.items()},
        ema_params=[p.detach() + 2 for p in model.parameters()])
    ckpt = CheckpointManager(tmp_path, keep_nbest=3)
    ckpt.save_epoch(1, model, state, prep.Reporter())
    want_next = torch.rand(4, generator=state.generator)
    fresh_model, fresh = _toy_state(ema=True, seed=123)
    restored = ckpt.restore(1, fresh_model, fresh)
    torch.testing.assert_close(fresh_model.w.detach(),
                               torch.tensor([1.5, -2.0]), rtol=0, atol=0)
    assert int(restored.step) == 7
    assert float(restored.lr_scale) == 0.25
    assert float(restored.gnorm_ema) == 3.5
    for k, v in state.opt_state.items():
        assert torch.equal(restored.opt_state[k], v)
    for a, b in zip(restored.ema_params, state.ema_params):
        assert torch.equal(a, b)
    # the generator continues the saved stream
    assert torch.equal(torch.rand(4, generator=restored.generator), want_next)
    # the file holds tensors only: weights_only loading
    tree = torch.load(tmp_path / "1epoch" / CKPT_FILE, weights_only=True)
    assert sorted(tree) == ["ema_params", "generator", "gnorm_ema",
                            "lr_scale", "opt_state", "params", "step"]
    assert json.loads((tmp_path / "latest.json").read_text()) == {"epoch": 1}


def test_prune_and_nbest_average(tmp_path):
    model, state = _toy_state()
    ckpt = CheckpointManager(tmp_path, keep_nbest=2)
    rep = prep.Reporter()
    rng = np.random.RandomState(0)
    saved = {}
    valid = {1: 5.0, 2: 3.0, 3: 4.0, 4: 6.0}
    for e, loss in valid.items():
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape)
                                         .astype(np.float32)))
        saved[e] = {k: v.clone() for k, v in model.state_dict().items()}
        rep.observe(e, "valid", {"loss": loss})
        ckpt.save_epoch(e, model, state, rep)
    # n-best (2, 3) plus the latest (4) are kept
    assert sorted(p.name for p in tmp_path.glob("*epoch")) == [
        "2epoch", "3epoch", "4epoch"]
    avg = ckpt.average_nbest(rep, 2)
    loaded = ckpt.load_params("valid.loss.ave_2best")
    for k in saved[2]:
        want = ((saved[2][k].numpy().astype(np.float64)
                 + saved[3][k].numpy().astype(np.float64)) / 2
                ).astype(np.float32)
        np.testing.assert_array_equal(avg[k].numpy(), want)
        np.testing.assert_array_equal(loaded[k].numpy(), want)
        assert loaded[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# Divergence guard and the all-invalid abort (tests/test_divergence_guard.py)
# ---------------------------------------------------------------------------


def _drift_step(model):
    """A train step that moves the parameters, so that a rollback is
    observable."""
    def step(st, batch):
        with torch.no_grad():
            model.w += 1.0
        return dataclasses.replace(st, step=st.step + 1), {
            "loss": torch.tensor(1.0)}
    return step


def _valid_from(table):
    def factory(epoch):
        yield {"loss": np.asarray(table[epoch], np.float32)}
    return factory


def _eval(st, batch):
    return {"loss": batch["loss"]}


def _guard_trainer(tmp_path, model, **opts):
    return Trainer(model, _drift_step(model), _eval,
                   CheckpointManager(tmp_path, keep_nbest=8),
                   TrainerOptions(nbest_average=1, **opts))


def test_trainer_rolls_back_on_a_valid_explosion(tmp_path):
    model, state = _toy_state()
    trainer = _guard_trainer(tmp_path, model, max_epoch=4, guard_factor=5.0,
                             guard_backoff=0.5)
    final = trainer.run(state, lambda e: iter([{}]),
                        _valid_from({1: 2.0, 2: 1.5, 3: 900.0, 4: 1.4}))
    # w: epoch 1 -> 1, epoch 2 -> 2 (saved), epoch 3 -> 3 (rolled back to
    # 2), epoch 4 -> 3.
    np.testing.assert_array_equal(model.w.detach().numpy(), [3.0, 3.0])
    assert float(final.lr_scale) == 0.5


def test_trainer_rollback_limit(tmp_path):
    model, state = _toy_state()
    trainer = _guard_trainer(tmp_path, model, max_epoch=10,
                             guard_factor=5.0, guard_max=2)
    table = {e: 1.0 if e == 1 else 1e6 for e in range(1, 11)}
    with pytest.raises(RuntimeError, match="divergence guard"):
        trainer.run(state, lambda e: iter([{}]), _valid_from(table))


def test_guard_margin_is_additive_around_a_negative_best(tmp_path):
    model, state = _toy_state()
    trainer = _guard_trainer(tmp_path, model, max_epoch=6,
                             guard_factor=5.0, guard_backoff=0.5,
                             guard_max=3)
    rolled = []
    orig = trainer._guard

    def spy(state_, reporter, epoch, phase, key, mode):
        out, r = orig(state_, reporter, epoch, phase, key, mode)
        if r:
            rolled.append(epoch)
        return out, r

    trainer._guard = spy
    final = trainer.run(state, lambda e: iter([{}]), _valid_from(
        {1: -0.07, 2: -0.17, 3: -0.12, 4: -0.18, 5: -0.16, 6: 40.0}))
    assert rolled == [6]
    assert float(final.lr_scale) == 0.5


def _guard_log(trainer, log):
    """Spies on trainer._guard: each guarded epoch's (epoch, rolled back,
    lr_scale after the guard) into log."""
    orig = trainer._guard

    def spy(state_, reporter, epoch, phase, key, mode):
        out, r = orig(state_, reporter, epoch, phase, key, mode)
        log.append((epoch, r, float(out.lr_scale)))
        return out, r
    trainer._guard = spy


def _guard_outcome(run, exp):
    """What a guarded run decided: the guard's log, the final w, the error
    it raised (None if it ended) and the epoch checkpoints left."""
    log, err, w = [], None, None
    try:
        w = run(log)
    except RuntimeError as e:
        err = str(e)
    return dict(log=log, w=w, err=err, dirs=sorted(
        p.name for p in Path(exp).glob("*epoch")))


def _reference_guard(exp, table, key, opts):
    import optax
    from espnet_slurp_tpu.train.checkpoint import \
        CheckpointManager as JCheckpointManager
    from espnet_slurp_tpu.train.state import TrainState as JTrainState

    def step(st, batch):
        return st.replace(step=st.step + 1,
                          params={"w": st.params["w"] + 1.0}), {"loss": 1.0}

    def run(log):
        state = JTrainState.create({"w": jnp.zeros((2,), jnp.float32)},
                                   optax.sgd(0.1), jax.random.PRNGKey(0),
                                   guard=True)
        trainer = jtrainer.Trainer(
            step, lambda st, b: dict(b), JCheckpointManager(
                exp, keep_nbest=opts["keep_nbest"]),
            jtrainer.TrainerOptions(tensorboard=False, plot_curves=False,
                                    nbest_average=1, **opts))
        _guard_log(trainer, log)
        final = trainer.run(state, lambda e: iter([{}]),
                            lambda e: iter([{key: table[e]}]))
        return np.asarray(final.params["w"]).tolist()
    return _guard_outcome(run, exp)


def _port_guard(exp, table, key, opts):
    def run(log):
        model, state = _toy_state()
        trainer = Trainer(model, _drift_step(model), lambda st, b: dict(b),
                          CheckpointManager(exp,
                                            keep_nbest=opts["keep_nbest"]),
                          TrainerOptions(nbest_average=1, **opts))
        _guard_log(trainer, log)
        trainer.run(state, lambda e: iter([{}]), lambda e: iter(
            [{key: np.asarray(table[e], np.float32)}]))
        return model.w.detach().numpy().tolist()
    return _guard_outcome(run, exp)


GUARD_CASES = {
    # tests/test_divergence_guard.py's three tables
    "explosion": ({1: 2.0, 2: 1.5, 3: 900.0, 4: 1.4}, "loss",
                  dict(max_epoch=4, keep_nbest=5)),
    "rollback_limit": ({e: 1.0 if e == 1 else 1e6 for e in range(1, 11)},
                       "loss", dict(max_epoch=10, keep_nbest=5,
                                    guard_max=2)),
    "negative_best": ({1: -0.07, 2: -0.17, 3: -0.12, 4: -0.18, 5: -0.16,
                       6: 40.0}, "loss", dict(max_epoch=6, keep_nbest=8)),
    # a non-finite criterion, then a best chosen among the checkpoints
    # that n-best pruning (keep 2) left
    "pruned_and_nan": ({1: 3.0, 2: 1.0, 3: 2.0, 4: 2.5, 5: float("nan"),
                        6: 1.2, 7: 80.0, 8: 0.9}, "loss",
                       dict(max_epoch=8, keep_nbest=2)),
    # near zero: the margin floor (1.0) puts the limit at 0.01 + 4 x 1.0,
    # past 3.9 and short of 4.1
    "margin_floor": ({1: 0.01, 2: 3.9, 3: 4.1, 4: 0.02}, "loss",
                     dict(max_epoch=4, keep_nbest=5)),
    # a criterion to maximise, with early stopping
    "max_mode_patience": ({1: 0.5, 2: 0.6, 3: -0.5, 4: 0.55, 5: 0.58,
                           6: 0.7}, "acc",
                          dict(max_epoch=6, keep_nbest=5, patience=2,
                               criterion=("valid", "acc", "max"))),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_decisions_equal_the_references(tmp_path, case):
    """The port's Trainer and the reference's run on the same valid tables:
    the same epochs rolled back, the same lr_scale after each guarded
    epoch, the same final w, the same abort and the same checkpoints left
    (exact)."""
    table, key, opts = GUARD_CASES[case]
    opts = dict(guard_factor=5.0, guard_backoff=0.5, **opts)
    ref = _reference_guard(tmp_path / "ref", table, key, opts)
    port = _port_guard(tmp_path / "port", table, key, opts)
    assert port == ref
    assert any(r for _, r, _ in ref["log"])


def test_all_invalid_epoch_aborts(tmp_path):
    model, state = _toy_state()

    def skipped_step(st, batch):
        return st, {"loss": torch.tensor(float("nan")),
                    "skipped": torch.tensor(1.0)}

    trainer = Trainer(model, skipped_step, _eval,
                      CheckpointManager(tmp_path / "port"), TrainerOptions())
    with pytest.raises(RuntimeError, match="non-finite gradients") as port:
        trainer.run(state, lambda e: iter([{}, {}]),
                    _valid_from({1: 1.0}))
    # the reference aborts the same epoch with the same message
    import optax
    from espnet_slurp_tpu.train.checkpoint import \
        CheckpointManager as JCheckpointManager
    from espnet_slurp_tpu.train.state import TrainState as JTrainState
    jstate = JTrainState.create({"w": jnp.zeros((2,), jnp.float32)},
                                optax.sgd(0.1), jax.random.PRNGKey(0),
                                guard=True)
    jtr = jtrainer.Trainer(
        lambda st, b: (st, {"loss": float("nan"), "skipped": 1.0}), _eval,
        JCheckpointManager(tmp_path / "ref"),
        jtrainer.TrainerOptions(tensorboard=False, plot_curves=False))
    with pytest.raises(RuntimeError) as ref:
        jtr.run(jstate, lambda e: iter([{}, {}]), _valid_from({1: 1.0}))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("sink", [dict(tensorboard=True), dict(use_wandb=True),
                                  dict(plot_curves=True),
                                  dict(profile_start_step=3)])
def test_unported_trainer_sinks_raise(tmp_path, sink):
    model, _ = _toy_state()
    with pytest.raises(NotImplementedError, match="queue 1 item 17"):
        Trainer(model, _drift_step(model), _eval, CheckpointManager(tmp_path),
                TrainerOptions(**sink))


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


def _resume_cfg(corpus, exp, max_epoch):
    return pasr.load_task_config(None, {
        "exp_dir": str(exp), "max_epoch": max_epoch, "nbest_average": 1,
        "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
                  "num_encoder_blocks": 1, "num_decoder_blocks": 1,
                  "decoder_d_ff": 64, "kernel_size": 7, "dropout_rate": 0.1,
                  "specaug": {"freq_mask_width_range": [0, 4],
                              "time_mask_width_range": [0, 8]},
                  "frontend": {"n_fft": 128, "hop_length": 64,
                               "n_mels": 16}},
        "optim": {"scheduler": "constant", "lr": 1e-3, "ema_decay": 0.9},
        "data": {"train_dir": str(corpus[0]), "valid_dir": str(corpus[1]),
                 "token_type": "char", "batch_type": "sorted",
                 "batch_size": 4}})


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """2 epochs in one run equal 1 epoch then a resumed epoch, bit for bit
    on the CPU: parameters, optimizer state, step, the generator (SpecAug
    and dropout at 0.1 draw from it), the EMA shadow, the guard's scalars
    and the reporter's losses."""
    corpus = make_mini_corpus(tmp_path / "corpus", n_train=10, n_dev=3)
    pasr.ASRTask.train(_resume_cfg(corpus, tmp_path / "a", 2), device="cpu")
    pasr.ASRTask.train(_resume_cfg(corpus, tmp_path / "b", 1), device="cpu")
    assert not (tmp_path / "b" / "2epoch").exists()
    pasr.ASRTask.train(_resume_cfg(corpus, tmp_path / "b", 2), device="cpu")
    a, b = (torch.load(tmp_path / x / "2epoch" / CKPT_FILE,
                       weights_only=True) for x in "ab")
    assert sorted(a) == sorted(b) and "ema_params" in a and "lr_scale" in a

    def same(x, y):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y, strict=True):
                same(u, v)
        else:
            assert torch.equal(x, y)

    same(a, b)
    ha, hb = (json.loads((tmp_path / x / "reporter.json").read_text())
              ["history"] for x in "ab")
    for ea, eb in zip(ha, hb, strict=True):
        for phase in ("train", "valid"):
            for k in ("loss", "loss_ctc", "loss_att", "acc", "grad_norm"):
                if k in ea[phase]:
                    assert ea[phase][k] == eb[phase][k], (phase, k)
    assert ha[1]["train"]["steps"] == 3 and ha[1]["train"]["skipped"] == 0


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("port,ref", [
    (poptim.OptimConfig, joptim.OptimConfig),
    (pasr.DataConfig, jasr.DataConfig),
    (pasr.MBRConfig, jmbr.MBRConfig)])
def test_config_defaults_equal_the_references(port, ref):
    assert _fields(port()) == _fields(ref())
    assert poptim.OptimConfig().spike_factor == 10.0


def test_task_config_and_trainer_option_defaults():
    """ASRTaskConfig(): every field the reference's default (the model's
    ASRConfig is held field by field in test_torch_train.py).
    TrainerOptions(): the reference's, but for the sinks that are not
    ported yet and default off."""
    pf, jf = _fields(pasr.ASRTaskConfig()), _fields(jasr.ASRTaskConfig())
    assert sorted(pf) == sorted(jf)
    for k in pf:
        if k == "model":
            continue
        if k in ("optim", "data", "mbr"):
            assert _fields(pf[k]) == _fields(jf[k]), k
        else:
            assert pf[k] == jf[k], k
    po, jo = _fields(TrainerOptions()), _fields(jtrainer.TrainerOptions())
    assert sorted(po) == sorted(jo)
    sinks = {"tensorboard", "plot_curves"}
    assert {k for k in po if po[k] != jo[k]} == sinks
    assert not any(po[k] for k in sinks)


# The ids keep the cases' names. model_arch: maskctc (override0) is ported
# (models/maskctc.py; tests/test_torch_maskctc.py trains it through
# bin/asr_train).
@pytest.mark.parametrize("override,match", [
    pytest.param({"mbr": {"weight": 0.5}}, None, id="override1-None"),
    pytest.param({"pipeline_stages": 2}, "item 17", id="override2-item 17"),
    pytest.param({"num_att_plot": 3}, "item 17", id="override3-item 17"),
    # ported since (data/resident.py)
    pytest.param({"data": {"resident_corpus": True}}, None,
                 id="override4-item 2"),
    pytest.param({"data": {"multichannel": True}}, "item 15",
                 id="override5-item 15"),
    pytest.param({"data": {"feats_type": "fbank_pitch"}}, "item 15",
                 id="override6-item 15"),
])
def test_unported_task_options_raise_naming_their_queue_item(
        tmp_path, override, match):
    cfg = pasr.load_task_config(None, {"exp_dir": str(tmp_path), **override})
    if match is None:
        # ported since: the config passes, and loads as the reference's
        # (MBR training itself: tests/test_torch_mbr.py)
        pasr.refuse_unported(cfg)
        ref = jasr.load_task_config(None, override)
        assert _fields(cfg.mbr) == _fields(ref.mbr)
        return
    with pytest.raises(NotImplementedError, match=match):
        pasr.ASRTask.train(cfg, device="cpu")


def test_a_reference_yaml_with_the_optimizer_guard_fields_loads(tmp_path):
    import yaml
    d = {"optim": {"grad_noise_eta": 0.01, "ema_decay": 0.999,
                   "spike_factor": 0.0, "decay_rate": 0.5, "momentum": 0.9}}
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(d))
    p = pasr.load_task_config(str(tmp_path / "c.yaml"))
    j = jasr.load_task_config(str(tmp_path / "c.yaml"))
    assert _fields(p.optim) == _fields(j.optim)


# ---------------------------------------------------------------------------
# The reference's init
# ---------------------------------------------------------------------------


def _configs(**kw):
    """(port ASRConfig, reference ASRConfig) with the same fields ``kw``
    and a micro frontend."""
    from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
    from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
    fe = dict(n_fft=128, hop_length=64, n_mels=16)
    port = pasr.ASRConfig(frontend=FrontendConfig(**fe), **kw)
    ref = dataclasses.replace(jasr.ASRTaskConfig().model,
                              frontend=JFront(**fe), **kw)
    return port, ref


def _assert_init_follows(model, again, ref, embeds, orthogonal=(),
                         fan_ins=None):
    """The port's init ``model`` (and ``again``, the same seed) against the
    reference's converted init ``ref``: zeros and ones exactly where the
    reference has them, else mean and std within 5 standard errors of the
    reference's sample; lecun_normal's truncation at 2 std for every
    matrix but the ``embeds`` (its fan_in the row's size, or ``fan_ins``'
    entry for a tensor laid out otherwise); each [P, P] gate block of the
    ``orthogonal`` recurrent kernels orthogonal on both sides."""
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        r = ref[k].double()
        p = v.double()
        assert torch.equal(again.state_dict()[k], v), k  # seeded
        if r.std() == 0:
            assert torch.equal(p, r), k
            continue
        n = r.numel()
        se = float(r.std()) / n ** 0.5
        assert abs(float(p.mean()) - float(r.mean())) < 5 * 2 ** 0.5 * se, k
        assert abs(float(p.std()) - float(r.std())) < 5 * float(r.std()) \
            * (1.0 / n) ** 0.5, k
        if k in orthogonal:
            eye = torch.eye(p.shape[1], dtype=torch.float64)
            for side in (p, r):
                for gate in side.view(4, p.shape[1], p.shape[1]):
                    torch.testing.assert_close(gate @ gate.T, eye,
                                               atol=1e-5, rtol=0)
        elif p.dim() >= 2 and k not in embeds:  # lecun_normal
            fan_in = (fan_ins or {}).get(k, v[0].numel())
            limit = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= limit * (1 + 1e-6), k
            assert float(r.abs().max()) <= limit * (1 + 1e-6), k


def test_init_params_follows_the_references_distributions():
    """Every tensor of ASRTask.init_params against the reference's flax init
    of the same config (_assert_init_follows)."""
    cfg, jcfg = _configs(vocab_size=100, d_model=64, n_head=4, d_ff=256,
                         num_encoder_blocks=2, num_decoder_blocks=1,
                         decoder_d_ff=256, kernel_size=15)
    ref = flax_to_torch(jax.tree.map(np.asarray, jasr.ASRTask.init_params(
        JaxASRModel(jcfg), 0)))
    model = pasr.ASRTask.init_params(ASRModel(cfg, device="cpu"), seed=0)
    again = pasr.ASRTask.init_params(ASRModel(cfg, device="cpu"), seed=0)
    _assert_init_follows(model, again, ref, embeds={"decoder.embed.weight"})


def test_moe_and_self_conditioning_init_follows_the_references():
    """ASRTask.init_params on an encoder with routed MoE blocks and
    self-conditioning (the router, the [E, in, out] expert kernels with
    flax's lecun_normal fan_in of E x in, their zero biases, sc_ctc and
    sc_cond) against the reference's flax init of the same config, by
    _assert_init_follows."""
    cfg, jcfg = _configs(vocab_size=100, d_model=64, n_head=4, d_ff=256,
                         num_encoder_blocks=2, num_decoder_blocks=1,
                         decoder_d_ff=256, kernel_size=15, moe_experts=4,
                         moe_every=1, interctc_layers=(1,),
                         interctc_weight=0.3, self_conditioning=True)
    ref = flax_to_torch(jax.tree.map(np.asarray, jasr.ASRTask.init_params(
        JaxASRModel(jcfg), 0)))
    assert {"encoder.block_0.moe.w1", "encoder.sc_cond.weight"} <= set(ref)
    model = pasr.ASRTask.init_params(ASRModel(cfg, device="cpu"), seed=0)
    again = pasr.ASRTask.init_params(ASRModel(cfg, device="cpu"), seed=0)
    # The expert kernels are [E, in, out]: flax's fan_in is E x in.
    experts = {k: v.shape[0] * v.shape[1] for k, v in ref.items()
               if k.endswith((".moe.w1", ".moe.w2"))}
    assert len(experts) == 4
    _assert_init_follows(model, again, ref, embeds={"decoder.embed.weight"},
                         fan_ins=experts)


def test_transducer_init_params_follows_the_references_distributions():
    """ASRTransducerTask.init_params (the init of every transducer run:
    bin/asr_transducer_train) against the reference task's flax init of
    the same TransducerModel: the encoder, the joint, the prediction
    network's embedding and its LSTM layer (flax's OptimizedLSTMCell:
    lecun_normal input kernels, an orthogonal recurrent kernel per gate,
    zero bias), by _assert_init_follows."""
    from espnet_slurp_tpu.models import transducer as jtd
    from espnet_slurp_tpu_torch.models.transducer import (TransducerConfig,
                                                          TransducerModel)
    from espnet_slurp_tpu_torch.tasks.asr_transducer import \
        ASRTransducerTask
    cfg, jcfg = _configs(vocab_size=100, d_model=64, n_head=4, d_ff=256,
                         num_encoder_blocks=2, kernel_size=15)
    head = dict(pred_dim=64, joint_dim=96)
    params = jtd.TransducerModel(jtd.TransducerConfig(asr=jcfg, **head)).init(
        jax.random.PRNGKey(0), np.zeros((2, 2400), np.float32),
        np.asarray([2400, 1700], np.int32), np.ones((2, 3), np.int32),
        np.asarray([3, 3], np.int32))["params"]
    ref = flax_to_torch(jax.tree.map(np.asarray, params))
    models = [ASRTransducerTask.init_params(TransducerModel(
        TransducerConfig(asr=cfg, **head), device="cpu"), seed=0)
        for _ in range(2)]
    lstm = [k for k in ref if k.endswith("weight_hh")]
    assert lstm
    _assert_init_follows(*models, ref, embeds={"prediction.embed.weight"},
                         orthogonal=set(lstm))


# ---------------------------------------------------------------------------
# Global MVN
# ---------------------------------------------------------------------------


def _stats(n_mels=16, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(500, n_mels) * 3 + 1
    return {"count": np.asarray(500.0), "sum": feats.sum(0),
            "sum_square": (feats ** 2).sum(0)}


def test_global_mvn_params_match(tmp_path):
    np.savez(tmp_path / "s.npz", **_stats())
    for a, b in zip(global_mvn_params(str(tmp_path / "s.npz")),
                    j_mvn_params(str(tmp_path / "s.npz"))):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_speech2text_decodes_with_the_global_mvn_stats(tmp_path, monkeypatch):
    """A use_mvn: global model: Speech2Text (and from_exp_dir, through
    ASRTask.load_mvn_stats) encodes with the stats, as the reference's
    encode with mvn_stats does."""
    cfg, jcfg = _configs(vocab_size=20, d_model=32, n_head=2, d_ff=64,
                         num_encoder_blocks=2, num_decoder_blocks=1,
                         decoder_d_ff=64, kernel_size=7, use_mvn="global")
    jmodel = JaxASRModel(jcfg)
    params = jax.tree.map(np.asarray, jasr.ASRTask.init_params(jmodel, 0))
    mean, inv = global_mvn_params(_stats())
    x, lens = waveforms([4096, 3100], seed=5)
    hs_ref, hl_ref, _ = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(
            s, sl, mvn_stats=(jnp.asarray(mean), jnp.asarray(inv))))
    port = ASRModel(cfg, device="cpu")
    port.load_state_dict(flax_to_torch(params))
    s2t = pasr.Speech2Text(port.cfg, port.state_dict(),
                           [str(i) for i in range(port.cfg.vocab_size)],
                           device="cpu", mvn_stats=(mean, inv), max_len=3)
    seen = []
    encode = s2t.model.encode

    def spy(speech, lengths, mvn_stats=None, **kw):
        seen.append(mvn_stats)
        return encode(speech, lengths, mvn_stats, **kw)

    monkeypatch.setattr(s2t.model, "encode", spy)
    s2t.decode_batch([x[0], x[1, :3100]])
    assert seen and seen[0] is s2t.mvn_stats
    with torch.no_grad():
        hs, hl = encode(t(x), t(lens), s2t.mvn_stats)
        hs_plain, _ = encode(t(x), t(lens))
    m = (np.arange(hs.shape[1])[None, :] < hl.numpy()[:, None])[..., None]
    np.testing.assert_allclose(np.where(m, hs.numpy(), 0),
                               np.where(m, np.asarray(hs_ref), 0),
                               atol=1e-4, rtol=1e-4)
    assert not torch.allclose(hs, hs_plain, atol=1e-2)
    # from an exp dir: the stats file under exp/stats is read
    exp = Path(tmp_path / "exp")
    cfg = pasr.ASRTaskConfig(exp_dir=str(exp), model=port.cfg)
    (exp / "stats").mkdir(parents=True)
    np.savez(exp / "stats" / "feats_stats.npz", **_stats())
    got = pasr.ASRTask.load_mvn_stats(cfg, "cpu")
    np.testing.assert_array_equal(got[0].numpy(), mean)
    np.testing.assert_array_equal(got[1].numpy(), inv)
