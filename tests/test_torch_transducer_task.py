"""The port's transducer task, CLIs and beam searches against the JAX
package, on the CPU.

- tasks/asr_transducer.py:ASRTransducerTask.train through the port's
  bin/asr_transducer_train (--device cpu), against the reference's task on
  the same YAML: a tiny Conformer-transducer (one block, d 32, LSTM 24,
  joint 40, auxiliary CTC 0.3, n_fft 128 / hop 64 / 16 mels, no SpecAug,
  dropout 0, word tokens, sorted batches, Adam at a constant 1e-3), two
  epochs on a 10 + 3 utterance mini corpus. The port starts from the
  reference's flax init (its first train batch, its seed), converted by
  utils/params.py. Per-epoch losses within LOSS_RTOL, as
  tests/test_torch_cli.py holds the ASR CLI's. A second call with
  max_epoch 3 resumes.
- bin/asr_transducer_inference with each search, text and score.txt.
- decode/transducer_beam.py: each of the five beam searches against the
  reference's on the same encoder output ``hs`` with converted weights, the
  joint sharpened (lin_out x3, lin_pred x4, blank's bias +5, so that every
  search emits a varying number of labels), fp32 (the port's bf16 decode
  carry differs by design: tests/test_torch_transducer.py). Tokens and
  lengths exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.decode import transducer_beam as jbeam
from espnet_slurp_tpu.models import transducer as jtd
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.tasks import asr_transducer as jtask
from espnet_slurp_tpu_torch.bin import asr_transducer_inference as p_infer
from espnet_slurp_tpu_torch.bin import asr_transducer_train as p_train
from espnet_slurp_tpu_torch.decode import transducer_beam as pbeam
from espnet_slurp_tpu_torch.models.transducer import TransducerModel
from espnet_slurp_tpu_torch.tasks import asr_transducer as ptask
from espnet_slurp_tpu_torch.utils import device as pdevice
from espnet_slurp_tpu_torch.utils.params import flax_to_torch

LOSS_RTOL = 1e-5
TINY = {
    "max_epoch": 2,
    "model": {"pred_dim": 24, "joint_dim": 40, "aux_ctc_weight": 0.3,
              "asr": {"d_model": 32, "n_head": 2, "d_ff": 64,
                      "num_encoder_blocks": 1, "kernel_size": 7,
                      "dropout_rate": 0.0, "specaug": None,
                      "frontend": {"n_fft": 128, "hop_length": 64,
                                   "n_mels": 16}}},
    "optim": {"scheduler": "constant", "lr": 1e-3},
    "data": {"token_type": "word", "batch_type": "sorted"},
}
SEARCHES = ("alsa", "default", "maes", "tsd", "nsc")


def _yaml(path, exp, corpus):
    cfg = json.loads(json.dumps(TINY))
    cfg["exp_dir"] = str(exp)
    cfg["data"].update(train_dir=str(corpus[0]), valid_dir=str(corpus[1]))
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _reference_init(jcfg):
    """The reference task's initial parameters: its model's flax init on
    its first train batch with PRNGKey(seed)."""
    asr_like = jtask._as_asr_cfg(jcfg)
    tok, conv, asr_cfg = jasr.ASRTask.prepare_vocab(asr_like)
    import dataclasses
    model = jtd.TransducerModel(dataclasses.replace(jcfg.model, asr=asr_cfg))
    ds = jasr.ASRTask.build_dataset(jcfg.data.train_dir, tok, conv)
    batch0 = next(iter(jasr.ASRTask.build_iter_factory(asr_like, ds)(1)))
    params = model.init(jax.random.PRNGKey(jcfg.data.seed), **batch0)
    return flax_to_torch(jax.tree.map(np.asarray, params["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("transducer")
    corpus = make_mini_corpus(root / "corpus", n_train=10, n_dev=3)
    jexp, pexp = root / "jax_exp", root / "port_exp"
    jyaml = _yaml(root / "jax.yaml", jexp, corpus)
    jcfg = jtask.load_transducer_config(jyaml)
    single = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: single)
        jtask.ASRTransducerTask.train(jcfg)
    init = _reference_init(jcfg)
    pyaml = _yaml(root / "port.yaml", pexp, corpus)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptask.ASRTransducerTask, "init_params",
                   staticmethod(lambda model, seed: model.load_state_dict(
                       init)))
        assert p_train.main(["--config", pyaml, "--device", "cpu"]) == 0
        two = json.loads((pexp / "reporter.json").read_text())["history"]
        assert p_train.main(["--config", pyaml, "--set", "max_epoch=3",
                             "--device", "cpu"]) == 0
    decs = {}
    for search in ("greedy",) + SEARCHES:
        decs[search] = root / f"dec_{search}"
        assert p_infer.main([
            "--exp_dir", str(pexp), "--data_dir", str(corpus[1]),
            "--output_dir", str(decs[search]), "--search", search,
            "--beam_size", "3", "--max_len", "12", "--batch_size", "2",
            "--device", "cpu"]) == 0
    return dict(corpus=corpus, jexp=jexp, pexp=pexp, pyaml=pyaml, two=two,
                decs=decs)


def test_train_cli_resumes_and_writes_the_checkpoints(runs):
    exp = runs["pexp"]
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1, 2, 3]
    assert hist[:2] == runs["two"]
    assert json.loads((exp / "latest.json").read_text()) == {"epoch": 3}
    for name in ("1epoch", "2epoch", "3epoch", "valid.loss.ave_3best"):
        assert (exp / name / "checkpoint.pth").exists(), name
    for e in hist:
        vals = [e[p][k] for p in ("train", "valid")
                for k in ("loss", "loss_transducer", "loss_ctc")]
        assert np.isfinite(vals).all() and e["train"]["skipped"] == 0.0
    cfg = ptask.load_transducer_config(str(exp / "config.yaml"))
    assert cfg.model.asr.vocab_size == len(
        (exp / "tokens.txt").read_text().split())


def test_per_epoch_losses_match_the_reference_task(runs):
    jh, ph = (json.loads((runs[k] / "reporter.json").read_text())["history"]
              for k in ("jexp", "pexp"))
    assert len(jh) == 2
    for je, pe in zip(jh, ph[:2]):
        for phase in ("train", "valid"):
            assert sorted(k for k in je[phase] if k.startswith("loss")) == [
                "loss", "loss_ctc", "loss_transducer"]
            for key in ("loss", "loss_transducer", "loss_ctc"):
                np.testing.assert_allclose(
                    pe[phase][key], je[phase][key], rtol=LOSS_RTOL,
                    err_msg=f"epoch {je['epoch']} {phase} {key}")
    assert ph[1]["train"]["loss"] < ph[0]["train"]["loss"]


@pytest.mark.parametrize("search", ("greedy",) + SEARCHES)
def test_inference_cli_writes_text_and_scores(runs, search):
    dec = runs["decs"][search]
    hyps = (dec / "text").read_text().splitlines()
    refs = (runs["corpus"][1] / "text").read_text().splitlines()
    assert sorted(h.split()[0] for h in hyps) == sorted(
        r.split()[0] for r in refs)
    score = dict(line.split() for line in
                 (dec / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]
    assert all(float(v) >= 0 for v in score.values())


def test_from_exp_dir_resolves_the_checkpoint_and_the_search(runs):
    s2t = ptask.Speech2TextTransducer.from_exp_dir(
        str(runs["pexp"]), beam_size=3, search="maes", device="cpu")
    assert s2t.task_cfg.data.token_type == "word"
    assert (s2t.search, s2t.beam_size) == ("maes", 3)
    with pytest.raises(ValueError, match="search"):
        ptask.Speech2TextTransducer.from_exp_dir(
            str(runs["pexp"]), search="beam", device="cpu")


def test_clis_raise_without_a_card_and_for_unported_options(runs, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_train.main(["--config", runs["pyaml"], "--set",
                          f"exp_dir={tmp_path / 'exp'}"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_infer.main(["--exp_dir", str(runs["pexp"]), "--data_dir",
                          str(runs["corpus"][1]), "--output_dir",
                          str(tmp_path / "dec")])
    with pytest.raises(ValueError, match="chunk_size > 0"):
        p_infer.main(["--exp_dir", str(runs["pexp"]), "--data_dir",
                      str(runs["corpus"][1]), "--output_dir",
                      str(tmp_path / "dec"), "--streaming", "--device",
                      "cpu"])
    with pytest.raises(NotImplementedError,
                       match="attaches no tries.*queue 3"):
        p_train.main(["--config", runs["pyaml"], "--set",
                      f"exp_dir={tmp_path / 'exp'}", "model.use_tcpgen=true",
                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 3"):
        p_train.main(["--config", runs["pyaml"], "--set",
                      f"exp_dir={tmp_path / 'exp'}",
                      "model.asr.moe_experts=4", "--device", "cpu"])


@pytest.mark.parametrize("search", ["greedy", "alsa"])
def test_streaming_cli_decodes_as_the_non_streaming_decode(runs, tmp_path,
                                                           search):
    """--streaming (in place of its refusal): a chunked model (chunk 4,
    left 1) trained one epoch by bin/asr_transducer_train decodes the dev
    set 2048 samples a call, and its final texts are the non-streaming
    decode's (fp32: the chunked encoder's frames do not depend on the
    audio after them)."""
    exp = tmp_path / "exp"
    assert p_train.main(["--config", runs["pyaml"], "--set",
                         f"exp_dir={exp}", "max_epoch=1",
                         "model.asr.chunk_size=4", "model.asr.left_chunks=1",
                         "--device", "cpu"]) == 0
    texts = {}
    for flags in ([], ["--streaming", "--chunk_samples", "2048"]):
        out = tmp_path / f"dec{len(flags)}"
        assert p_infer.main(["--exp_dir", str(exp), "--data_dir",
                             str(runs["corpus"][1]), "--output_dir",
                             str(out), "--search", search, "--beam_size",
                             "3", "--max_len", "12", "--device", "cpu",
                             *flags]) == 0
        texts[len(flags)] = (out / "text").read_text()
        assert (out / "score.txt").exists()
    assert texts[0] == texts[3]


# --- the beam searches ------------------------------------------------------

HEAD = dict(pred_dim=24, joint_dim=40, aux_ctc_weight=0.3)
ASR = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
           num_encoder_blocks=1, kernel_size=7, dropout_rate=0.0,
           specaug=None)


@pytest.fixture(scope="module")
def search_models():
    """{seed: (flax model, params, port model)} with the joint sharpened
    and blank favoured."""
    from espnet_slurp_tpu.models.asr_model import ASRConfig as JASR
    from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
    from torch_parity import tiny_port_cfg
    jmodel = jtd.TransducerModel(jtd.TransducerConfig(
        asr=JASR(frontend=JFront(n_fft=128, hop_length=64, n_mels=16),
                 **ASR), **HEAD))
    out = {}
    init = jax.jit(jmodel.init)
    for seed in range(3):
        params = jax.tree.map(np.array, init(
            jax.random.PRNGKey(seed), np.zeros((2, 2400), np.float32),
            np.asarray([2400, 1700], np.int32), np.ones((2, 3), np.int32),
            np.asarray([3, 3], np.int32))["params"])
        params["joint"]["lin_out"]["kernel"] *= 3.0
        params["joint"]["lin_pred"]["kernel"] *= 4.0
        params["joint"]["lin_out"]["bias"][0] += 5.0
        pmodel = TransducerModel(ptask.TransducerConfig(
            asr=tiny_port_cfg(**ASR), **HEAD), device="cpu")
        pmodel.load_state_dict(flax_to_torch(params))
        out[seed] = (jmodel, params, pmodel)
    return out


def _configs(search, k, l):
    return {"alsa": (jbeam.TransducerBeamConfig(k, max_len=l),
                     pbeam.TransducerBeamConfig(k, max_len=l)),
            "default": (jbeam.DefaultBeamConfig(k, l),
                        pbeam.DefaultBeamConfig(k, l)),
            "maes": (jbeam.MAESConfig(k, max_len=l),
                     pbeam.MAESConfig(k, max_len=l)),
            "tsd": (jbeam.TSDConfig(k, max_len=l),
                    pbeam.TSDConfig(k, max_len=l)),
            "nsc": (jbeam.NSCConfig(k, max_len=l),
                    pbeam.NSCConfig(k, max_len=l))}[search]


FNS = {"alsa": "transducer_beam_search", "default": "default_beam_search",
       "maes": "maes_search", "tsd": "tsd_search", "nsc": "nsc_search"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("search", SEARCHES)
def test_beam_search_equals_the_references(search_models, search, seed):
    jmodel, params, pmodel = search_models[seed]
    rng = np.random.RandomState(seed)
    hs = (rng.randn(3, 9, 32) * 2).astype(np.float32)
    hl = np.asarray([9, 6, 4], np.int32)
    jcfg, pcfg = _configs(search, 4, 12)
    jt, jl = getattr(jbeam, FNS[search])(jmodel, params, jnp.asarray(hs),
                                         jnp.asarray(hl), jcfg)
    syncs = pdevice.host_syncs
    pt, pl = getattr(pbeam, FNS[search])(pmodel, torch.from_numpy(hs),
                                         torch.from_numpy(hl), pcfg)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    # the frame-synchronous searches read nothing back inside their loops
    if search in ("maes", "tsd", "nsc"):
        assert pdevice.host_syncs == syncs


@pytest.mark.parametrize("search", SEARCHES)
def test_run_search_with_score_returns_the_chosen_hypothesis_score(
        search_models, search):
    """with_score adds the chosen hypotheses' scores (finite log
    probabilities, none the NEG of an empty slot) and changes nothing
    else; greedy keeps no score and refuses it."""
    _, _, pmodel = search_models[0]
    hs = torch.from_numpy((np.random.RandomState(0).randn(3, 9, 32) * 2)
                          .astype(np.float32))
    hl = torch.tensor([9, 6, 4])
    pt, pl = pbeam.run_search(pmodel, hs, hl, search, 4, 12)
    st, sl, score = pbeam.run_search(pmodel, hs, hl, search, 4, 12,
                                     with_score=True)
    assert torch.equal(st, pt) and torch.equal(sl, pl)
    assert score.shape == (3,) and score.dtype == torch.float32
    assert bool(torch.isfinite(score).all()) and bool((score <= 0).all())
    assert bool((score > pbeam.NEG / 2).all())
    with pytest.raises(ValueError, match="greedy"):
        pbeam.run_search(pmodel, hs, hl, "greedy", 4, 12, with_score=True)


def test_the_searches_emit_a_varying_number_of_labels(search_models):
    """The sharpened joint makes the comparisons above non-trivial: over
    the seeds each search emits lengths other than 0 and max_len."""
    for search in SEARCHES:
        seen = set()
        for seed, (_, _, pmodel) in search_models.items():
            rng = np.random.RandomState(seed)
            hs = torch.from_numpy((rng.randn(3, 9, 32) * 2).astype(
                np.float32))
            _, pl = getattr(pbeam, FNS[search])(
                pmodel, hs, torch.tensor([9, 6, 4]), _configs(search, 4,
                                                              12)[1])
            seen |= set(pl.tolist())
        assert seen - {0, 12}, (search, seen)


def test_topk_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30]])
    v, i = pbeam.topk(x, 5)
    assert i.tolist() == [[1, 2, 4, 0, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert np.asarray(ji).tolist() == i.tolist()
