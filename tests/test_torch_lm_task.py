"""The port's LM task (tasks/lm.py, bin/lm_train.py,
bin/lm_calc_perplexity.py) against the reference's on the CPU: the
batches (shuffled per epoch; sos-prefixed inputs, eos-suffixed targets,
lengths padded to a multiple of 8) equal; two train steps from one init
(the flax parameters converted) give losses within 1e-5 relative, Adam's
update included; the perplexity of the reference's trained LM, its
parameters converted into a port experiment, within 1e-5 relative; both
CLIs on the CPU (train, resume, perplexity)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from espnet_slurp_tpu.models.lm import lm_loss as j_lm_loss
from espnet_slurp_tpu.tasks import lm as jtask
from espnet_slurp_tpu.train.checkpoint import CheckpointManager as JCkpt
from espnet_slurp_tpu.train.optim import OptimConfig as JOptim
from espnet_slurp_tpu.train.optim import build_optimizer as j_build_optimizer
from espnet_slurp_tpu_torch.bin import lm_calc_perplexity as p_ppl
from espnet_slurp_tpu_torch.bin import lm_train as p_train
from espnet_slurp_tpu_torch.tasks import lm as ptask
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.train.optim import OptimConfig as POptim
from espnet_slurp_tpu_torch.train.optim import build_optimizer
from espnet_slurp_tpu_torch.train.state import TrainState
from espnet_slurp_tpu_torch.utils.config import save_yaml
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

WORDS = "the a cat dog sat ran on mat log fast and of".split()
MODEL = dict(d_model=16, n_head=2, d_ff=32, num_blocks=1, num_layers=1)
RTOL = 1e-5


def _texts(root, seed=0):
    rng = np.random.RandomState(seed)
    paths = {}
    for split, n in (("train", 21), ("valid", 6)):
        lines = [" ".join(rng.choice(WORDS, rng.randint(2, 12)))
                 for _ in range(n)]
        paths[split] = root / f"{split}_text"
        paths[split].write_text("".join(f"u{i:03d} {x}\n"
                                        for i, x in enumerate(lines)))
    return paths


def _cfgs(root, arch="transformer", **over):
    paths = _texts(root)
    common = {"exp_dir": str(root / "exp"), "max_epoch": 2, "keep_nbest": 2,
              **over}
    data = dict(train_text=str(paths["train"]),
                valid_text=str(paths["valid"]), token_type="word",
                batch_size=4, max_len=9)
    optim = dict(lr=1e-2, scheduler="constant")
    jcfg = jtask.LMTaskConfig(
        model=jtask.LMConfig(arch=arch, **MODEL),
        optim=JOptim(**optim), data=jtask.LMDataConfig(**data), **common)
    pcfg = ptask.LMTaskConfig(
        model=ptask.LMConfig(arch=arch, **MODEL),
        optim=POptim(**optim), data=ptask.LMDataConfig(**data), **common)
    return jcfg, pcfg, paths


def test_batches_equal_the_references(tmp_path):
    jcfg, pcfg, paths = _cfgs(tmp_path)
    jtok, jconv, jmodel = jtask.LMTask.prepare_vocab(jcfg)
    ptok, pconv, pmodel = ptask.LMTask.prepare_vocab(pcfg)  # reuses tokens
    assert pconv.token_list == jconv.token_list
    assert pmodel.vocab_size == jmodel.vocab_size == len(WORDS) + 3
    for epoch, shuffle in ((1, False), (1, True), (2, True)):
        ref = list(jtask.LMTask.batches(str(paths["train"]), jtok, jconv,
                                        jcfg, epoch, shuffle))
        got = list(ptask.LMTask.batches(str(paths["train"]), ptok, pconv,
                                        pcfg, epoch, shuffle))
        assert len(got) == len(ref) == 6
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for k in r:
                assert g[k].dtype == torch.long
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
            assert g["ys"].shape[1] % 8 == 0


@pytest.mark.parametrize("arch", ["transformer", "lstm"])
def test_train_steps_match_from_one_init(tmp_path, arch):
    jcfg, pcfg, paths = _cfgs(tmp_path, arch=arch)
    jtok, jconv, jmcfg = jtask.LMTask.prepare_vocab(jcfg)
    ptok, pconv, pmcfg = ptask.LMTask.prepare_vocab(pcfg)
    batches = list(jtask.LMTask.batches(str(paths["train"]), jtok, jconv,
                                        jcfg, 1, True))[:2]
    jm = jtask.build_lm(jmcfg)
    params = jm.init(jax.random.PRNGKey(0), batches[0]["ys"],
                     batches[0]["ys_lengths"])["params"]
    tx = j_build_optimizer(jcfg.optim)
    opt = tx.init(params)

    @jax.jit
    def jstep(params, opt, batch):
        def loss_fn(p):
            logits = jm.apply({"params": p}, batch["ys"],
                              batch["ys_lengths"])
            return j_lm_loss(logits, batch["targets"],
                             batch["ys_lengths"])[0]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    pm = ptask.build_lm(pmcfg, device="cpu")
    pm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    ptx = build_optimizer(pcfg.optim)
    state = TrainState.create(pm, ptx)
    step = ptask.make_lm_train_step(pm, ptx)
    for batch in batches:
        params, opt, ref = jstep(params, opt, batch)
        state, stats = step(state, {k: torch.tensor(np.asarray(v)).long()
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(stats["loss"]), float(ref),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(stats["ppl"]), float(np.exp(ref)),
                                   rtol=RTOL)


def test_perplexity_of_the_references_lm(tmp_path):
    jcfg, pcfg, paths = _cfgs(tmp_path, max_epoch=1)
    jcfg = dataclasses.replace(jcfg, exp_dir=str(tmp_path / "jexp"))
    jtask.LMTask.train(jcfg)
    ref = jtask.LMTask.perplexity(jcfg.exp_dir, str(paths["valid"]))
    # the port's experiment (config.yaml, tokens.txt, 1epoch), its
    # parameters replaced by the reference's
    ptask.LMTask.train(pcfg, device="cpu")
    ckpt = tmp_path / "exp" / "1epoch" / CKPT_FILE
    tree = torch.load(ckpt, weights_only=True)
    tree["params"] = flax_to_torch(jax.tree.map(
        np.asarray, JCkpt(jcfg.exp_dir).load_params("1epoch")))
    torch.save(tree, ckpt)
    got = ptask.LMTask.perplexity(pcfg.exp_dir, str(paths["valid"]),
                                  device="cpu")
    assert np.isfinite(ref) and ref > 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_clis_train_resume_and_score_on_the_cpu(tmp_path, capsys):
    _, pcfg, paths = _cfgs(tmp_path, max_epoch=1)
    cfg_path = tmp_path / "lm.yaml"
    save_yaml(pcfg, cfg_path)
    assert p_train.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    exp = tmp_path / "exp"
    assert p_train.main(["--config", str(cfg_path), "--set", "max_epoch=3",
                         "--device", "cpu"]) == 0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1, 2, 3]
    losses = [e["train"]["loss"] for e in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert json.loads((exp / "latest.json").read_text()) == {"epoch": 3}
    capsys.readouterr()
    assert p_ppl.main(["--exp_dir", str(exp), "--text", str(paths["valid"]),
                       "--device", "cpu"]) == 0
    printed = float(capsys.readouterr().out.split()[-1])
    want = ptask.LMTask.perplexity(str(exp), str(paths["valid"]),
                                   device="cpu")
    assert abs(printed - want) < 1e-3
    assert np.isfinite(want) and want > 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_train.main(["--config", str(cfg_path)])
