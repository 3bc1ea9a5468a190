"""The verify recipe through both packages' CLIs, in-process (``main(argv)``):
a micro model (d_model 32, one block, n_fft 128 / hop 64 / 16 mels, no
SpecAug, no MVN, word tokens, sorted batches, dropout 0, Adam at a constant
1e-3) trained 2 epochs on a 10 + 3 utterance mini corpus.

The JAX CLI trains first, on one CPU device as the recipe runs it; its
initial parameters (the reference's ``ASRTask.init_params`` for the same
config and seed), converted by ``utils/params.py``, reach the port's CLI
through ``init_params_from``. Both then see the same batches, so their
per-epoch train and valid losses agree within LOSS_RTOL: fp32 on the CPU
on both sides, two Adam steps (seen: 2e-7 apart, relative)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.bin import asr_train as j_train
from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.utils.config import to_dict as j_to_dict
from espnet_slurp_tpu_torch.bin import asr_inference as p_infer
from espnet_slurp_tpu_torch.bin import asr_train as p_train
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.utils.config import save_yaml, to_dict
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

LOSS_RTOL = 1e-5
MICRO = {
    "max_epoch": 2,
    "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
              "num_encoder_blocks": 1, "num_decoder_blocks": 1,
              "decoder_d_ff": 64, "kernel_size": 7, "dropout_rate": 0.0,
              "specaug": None, "use_mvn": "none",
              "frontend": {"n_fft": 128, "hop_length": 64, "n_mels": 16}},
    "optim": {"scheduler": "constant", "lr": 1e-3},
    "data": {"token_type": "word", "batch_type": "sorted"},
}


def _yaml(path, exp, corpus, **extra):
    import yaml
    cfg = json.loads(json.dumps(MICRO))
    cfg["exp_dir"] = str(exp)
    cfg["data"].update(train_dir=str(corpus[0]), valid_dir=str(corpus[1]))
    cfg.update(extra)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    corpus = make_mini_corpus(root / "corpus", n_train=10, n_dev=3)
    jexp, pexp = root / "jax_exp", root / "port_exp"
    jyaml = _yaml(root / "jax.yaml", jexp, corpus)
    single = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        # One CPU device, as the recipe runs (the test session has eight).
        mp.setattr(jax, "devices", lambda *a, **k: single)
        assert j_train.main(["--config", jyaml]) == 0
    # The JAX CLI's initial parameters, into the port's checkpoint format.
    jcfg = jasr.load_task_config(jyaml)
    _, _, jmodel_cfg = jasr.ASRTask.prepare_vocab(jcfg)
    params = jasr.ASRTask.init_params(JaxASRModel(jmodel_cfg), jcfg.data.seed)
    init_dir = root / "init"
    init_dir.mkdir()
    torch.save({"params": flax_to_torch(jax.tree.map(np.asarray, params))},
               init_dir / CKPT_FILE)
    pyaml = _yaml(root / "port.yaml", pexp, corpus,
                  init_params_from=str(init_dir))
    assert p_train.main(["--config", pyaml, "--device", "cpu"]) == 0
    dec = root / "decode"
    assert p_infer.main(["--exp_dir", str(pexp), "--data_dir",
                         str(corpus[1]), "--output_dir", str(dec),
                         "--beam_size", "4", "--max_len", "12",
                         "--device", "cpu"]) == 0
    return dict(corpus=corpus, jexp=jexp, pexp=pexp, dec=dec, pyaml=pyaml)


def test_port_cli_writes_the_recipes_artefacts(runs):
    exp = runs["pexp"]
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1, 2]
    assert json.loads((exp / "latest.json").read_text()) == {"epoch": 2}
    for name in ("1epoch", "2epoch", "valid.loss.ave_2best"):
        assert (exp / name / CKPT_FILE).exists(), name
    for e in hist:
        assert e["train"]["steps"] == 1 and e["train"]["skipped"] == 0.0
        assert e["train"]["iter_time"] >= 0 and e["train"]["step_time"] > 0
        assert np.isfinite(e["valid"]["loss"])


def test_per_epoch_losses_match_the_reference_cli(runs):
    jh, ph = (json.loads((runs[k] / "reporter.json").read_text())["history"]
              for k in ("jexp", "pexp"))
    assert len(jh) == len(ph) == 2
    for je, pe in zip(jh, ph):
        for phase in ("train", "valid"):
            for key in ("loss", "loss_ctc", "loss_att", "acc"):
                np.testing.assert_allclose(
                    pe[phase][key], je[phase][key], rtol=LOSS_RTOL,
                    err_msg=f"epoch {je['epoch']} {phase} {key}")
    assert ph[1]["train"]["loss"] < ph[0]["train"]["loss"]


def _shared(port, ref):
    """ref restricted to the keys of port, nested dicts walked."""
    return {k: (_shared(v, ref[k]) if isinstance(v, dict) else ref[k])
            for k, v in port.items()}


def test_port_config_loads_in_the_reference(runs):
    exp = runs["pexp"]
    pcfg = pasr.load_task_config(str(exp / "config.yaml"))
    pd = to_dict(pcfg)
    jd = j_to_dict(jasr.load_task_config(str(exp / "config.yaml")))
    assert _shared(pd, jd) == pd
    # and the two CLIs resolved the same experiment
    jown = j_to_dict(jasr.load_task_config(
        str(runs["jexp"] / "config.yaml")))
    skip = {"exp_dir", "init_params_from"}
    assert ({k: v for k, v in _shared(pd, jown).items() if k not in skip}
            == {k: v for k, v in pd.items() if k not in skip})
    tokens = (exp / "tokens.txt").read_text().split()
    assert pcfg.model.vocab_size == len(tokens) == jown["model"]["vocab_size"]
    # a port-only option set away from its default is written
    fused = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, fused_conv=True))
    save_yaml(fused, exp / "fused.yaml")
    assert pasr.load_task_config(str(exp / "fused.yaml")) == fused


def test_inference_cli_writes_text_and_scores(runs):
    hyps = (runs["dec"] / "text").read_text().splitlines()
    refs = (runs["corpus"][1] / "text").read_text().splitlines()
    assert [h.split()[0] for h in hyps] == [r.split()[0] for r in refs]
    score = dict(line.split() for line in
                 (runs["dec"] / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]
    assert all(float(v) >= 0 for v in score.values())
    s2t = pasr.Speech2Text.from_exp_dir(str(runs["pexp"]), device="cpu",
                                        max_len=12)
    assert s2t.task_cfg.data.token_type == "word"
    assert s2t.converter.token_list == (
        runs["pexp"] / "tokens.txt").read_text().split()


def test_clis_raise_without_a_card_unless_asked_for_the_cpu(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        p_train.main(["--config", runs["pyaml"], "--set",
                      f"exp_dir={tmp_path / 'exp'}"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        p_infer.main(["--exp_dir", str(runs["pexp"]), "--data_dir",
                      str(runs["corpus"][1]), "--output_dir",
                      str(tmp_path / "dec")])


def _reference_weights_exp(runs, root):
    """A port experiment holding the reference CLI's weights (its n-best
    average, converted): the port's config and tokens, checkpoint "jax"."""
    import shutil
    ref = jasr.Speech2Text(str(runs["jexp"]))
    exp = root / "jax_weights"
    (exp / "jax").mkdir(parents=True)
    for name in ("config.yaml", "tokens.txt"):
        shutil.copy(runs["pexp"] / name, exp / name)
    torch.save({"params": flax_to_torch(jax.tree.map(np.asarray,
                                                     ref.params))},
               exp / "jax" / CKPT_FILE)
    return exp


@pytest.mark.parametrize("flag", [["--ctc_timesync"], ["--lattice"]])
def test_inference_cli_decodes_as_the_references_speech2text(runs, tmp_path,
                                                             flag):
    """--ctc_timesync and --lattice through the port's bin/asr_inference on
    the CPU, from the reference CLI's weights: the texts of the reference's
    Speech2Text with the same flag (beam 4, max_len 12; the lattice's
    decoder at 0.3)."""
    dec = tmp_path / "dec"
    assert p_infer.main(["--exp_dir", str(_reference_weights_exp(
        runs, tmp_path)), "--ckpt", "jax", "--data_dir",
        str(runs["corpus"][1]), "--output_dir", str(dec), "--beam_size", "4",
        "--max_len", "12", "--device", "cpu", *flag]) == 0
    ref = jasr.Speech2Text(str(runs["jexp"]), max_len=12, beam_size=4,
                           ctc_weight=0.3, **{flag[0][2:]: True})
    from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
    wavs = read_2column_text(runs["corpus"][1] / "wav.scp")
    audio = sorted(((uid, load_wav(p)[0]) for uid, p in wavs.items()),
                   key=lambda x: len(x[1]))
    want = dict(zip([u for u, _ in audio],
                    ref.decode_batch([w for _, w in audio])))
    got = dict((line.split(" ", 1) + [""])[:2]
               for line in (dec / "text").read_text().splitlines())
    assert got == want
    score = dict(line.split() for line in
                 (dec / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]


def _lm_exp(runs, root):
    """A Transformer LM trained one epoch by bin/lm_train on the corpus's
    train text, over the ASR experiment's token list."""
    from espnet_slurp_tpu_torch.bin import lm_train
    exp = root / "lm"
    exp.mkdir()
    (exp / "tokens.txt").write_text((runs["pexp"] / "tokens.txt").read_text())
    text = str(runs["corpus"][0] / "text")
    assert lm_train.main([
        "--set", f"exp_dir={exp}", "data.token_type=word",
        f"data.train_text={text}", f"data.valid_text={text}",
        "model.d_model=16", "model.n_head=2", "model.d_ff=32",
        "model.num_blocks=1", "max_epoch=1", "--device", "cpu"]) == 0
    return exp


def _ngram(runs, root):
    """bin/ngram_compile's cache of a trigram over the train text."""
    from espnet_slurp_tpu_torch.bin import ngram_compile
    from espnet_slurp_tpu_torch.decode.ngram_train import train_arpa_from_file
    arpa = train_arpa_from_file(runs["corpus"][0] / "text", root / "lm.arpa")
    out = root / "lm.npz"
    assert ngram_compile.main(["--arpa", str(arpa), "--tokens",
                               str(runs["pexp"] / "tokens.txt"), "--output",
                               str(out)]) == 0
    return out


@pytest.mark.parametrize("scorer", ["lm", "ngram"])
def test_inference_cli_fuses_an_lm_or_an_ngram(runs, tmp_path, scorer):
    """conf/decode.yaml's lm_weight 0.3 through bin/asr_inference on the
    CPU (a bin/lm_train LM, or an n-gram cache of bin/ngram_compile): the
    CLI's hypotheses are those of Speech2Text with the same fusion."""
    flags = (["--lm_exp_dir", str(_lm_exp(runs, tmp_path)), "--lm_weight",
              "0.3"] if scorer == "lm" else
             ["--ngram_file", str(_ngram(runs, tmp_path)), "--ngram_weight",
              "0.3"])
    dec = tmp_path / "dec"
    assert p_infer.main(["--exp_dir", str(runs["pexp"]), "--data_dir",
                         str(runs["corpus"][1]), "--output_dir", str(dec),
                         "--beam_size", "4", "--max_len", "12", "--device",
                         "cpu", *flags]) == 0
    kw = dict(zip([f[2:] for f in flags[::2]],
                  [flags[1], float(flags[3])]))
    s2t = pasr.Speech2Text.from_exp_dir(str(runs["pexp"]), device="cpu",
                                        max_len=12, beam_size=4,
                                        ctc_weight=0.3, **kw)
    from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
    wavs = read_2column_text(runs["corpus"][1] / "wav.scp")
    want = dict(zip(wavs, s2t.decode_batch([load_wav(p)[0]
                                            for p in wavs.values()])))
    got = dict(line.split(" ", 1) if " " in line else (line, "")
               for line in (dec / "text").read_text().splitlines())
    assert got == want
    assert len(s2t._scorers) == 1
    score = dict(line.split() for line in
                 (dec / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]
