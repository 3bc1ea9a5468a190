"""The port's recipe layer against the JAX package, on the CPU:
ops/resample.py (speed perturbation), bin/aggregate_stats_dirs.py,
train/collect_stats.py (global MVN stats) and recipe/asr_pipeline.py
(stages 1-15, with bin/pack.py's pack / unpack / publish / fetch).

Both pipelines run tests/test_recipe.py's tiny config (d_model 32, one
block each side, n_fft 128 / hop 64 / 16 mels, no SpecAug, global MVN,
word tokens, speed perturbation 0.9 / 1.0, one epoch, beam 2, max_len 8)
without the LM and the n-gram, over the same mini corpus; stages 7-9 (the
LM and the n-gram) and stage 12 with the n-gram then run on copies of the
trained experiments. The JAX pipeline
runs on one CPU device, as the recipe runs; its initial parameters reach
the port's through ``init_params_from`` (converted by utils/params.py).
Tolerances: the speed-perturbed waveforms exactly (the same numpy code);
the stats' count exactly, sum and sum_square within STATS_RTOL of max |ref|
(fp32 batch sums in another order, accumulated in fp64 on both sides); the
per-epoch losses within LOSS_RTOL (as tests/test_torch_cli.py); token
lists and decoded texts exactly."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.models.asr_model import ASRConfig as JASRConfig
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.ops import resample as jres
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFrontend
from espnet_slurp_tpu.recipe import asr_pipeline as jpipe
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.train.collect_stats import collect_stats as j_collect
from espnet_slurp_tpu.train.optim import OptimConfig as JOptim
from espnet_slurp_tpu_torch.bin import aggregate_stats_dirs as p_agg
from espnet_slurp_tpu_torch.bin import pack as p_pack
from espnet_slurp_tpu_torch.ops import resample as pres
from espnet_slurp_tpu_torch.recipe import asr_pipeline as ppipe
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.train.collect_stats import collect_stats
from espnet_slurp_tpu_torch.utils.config import from_dict
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

STATS_RTOL = 1e-5
LOSS_RTOL = 1e-5
MODEL = dict(d_model=32, n_head=2, d_ff=64, num_encoder_blocks=1,
             num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
             dropout_rate=0.0, ctc_weight=0.3, use_mvn="global",
             specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
DATA = dict(token_type="word", batch_type="sorted", batch_size=8,
            speech_bucket_multiple=2048, text_bucket_multiple=4)
OPTS = dict(speed_perturb_factors=(0.9, 1.0), decode_beam_size=2,
            decode_max_len=8)


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1, 1.37])
def test_speed_perturb_equals_the_references(factor):
    """Exactly, over several of the port's blocks of output samples."""
    rng = np.random.RandomState(0)
    x = rng.randn(20001).astype(np.float32)
    y = pres.speed_perturb(x, factor)
    np.testing.assert_array_equal(y, jres.speed_perturb(x, factor))
    assert y.dtype == np.float32 and abs(len(y) - 20001 / factor) < 1


def test_speed_perturbation_holds_a_window_of_utterances(tmp_path,
                                                        monkeypatch):
    """Stage 2 with a window of 2 over 7 utterances: no more than 2 read
    and not yet written at once, and the same data dir as the reference's
    (its lists in the same order, every copy's samples exactly)."""
    from espnet_slurp_tpu_torch.data.fileio import load_wav
    train, _ = make_mini_corpus(tmp_path / "c", n_train=7, n_dev=1)
    factors = (0.9, 1.0, 1.1)
    held, peak = [0, 0], [0]  # utterances read, copies written

    def counted_load(path):
        held[0] += 1
        peak[0] = max(peak[0], held[0] - held[1] // 2)
        return load_wav(path)

    def counted_write(path, x, sr):
        held[1] += 1
        return write_wav(path, x, sr)

    write_wav = ppipe.write_wav
    monkeypatch.setattr(ppipe, "SP_WINDOW", 2)
    monkeypatch.setattr(ppipe, "load_wav", counted_load)
    monkeypatch.setattr(ppipe, "write_wav", counted_write)
    got = ppipe.stage2_speed_perturb(train, tmp_path / "port", factors)
    want = jpipe.stage2_speed_perturb(train, tmp_path / "ref", factors)
    assert held == [7, 14] and peak[0] == 2
    for name in ("wav.scp", "text"):
        lines = [(g.split(maxsplit=1), w.split(maxsplit=1)) for g, w in zip(
            (got / name).read_text().splitlines(),
            (want / name).read_text().splitlines(), strict=True)]
        assert [g[0] for g, _ in lines] == [w[0] for _, w in lines]
        for g, w in lines:
            if name == "text":
                assert g == w
            else:
                np.testing.assert_array_equal(load_wav(g[1])[0],
                                              load_wav(w[1])[0])


def test_resample_linear_device_equals_the_references():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3001).astype(np.float32)
    want = np.asarray(jres.resample_linear_device(x, 1.1, 2700))
    got = pres.resample_linear_device(torch.from_numpy(x), 1.1, 2700)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _stats_dir(d, utts, seed):
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True)
    (d / "speech_shape").write_text(
        "".join(f"{u} {rng.randint(3, 99)},16\n" for u in utts))
    np.savez(d / "feats_stats.npz", count=np.asarray(rng.randint(9, 99)),
             sum=rng.randn(16), sum_square=rng.rand(16))


@pytest.mark.parametrize("sub", ["", "train"])
def test_aggregate_stats_dirs_equals_the_references(tmp_path, sub):
    from espnet_slurp_tpu.bin.aggregate_stats_dirs import main as j_main
    ins = []
    for i, utts in enumerate((["c", "a"], ["b"], ["e", "d"])):
        _stats_dir(tmp_path / f"s{i}" / sub, utts, i)
        ins += ["--input_dir", str(tmp_path / f"s{i}")]
    assert j_main(ins + ["--output_dir", str(tmp_path / "j")]) == 0
    assert p_agg.main(ins + ["--output_dir", str(tmp_path / "p")]) == 0
    j, p = tmp_path / "j" / sub, tmp_path / "p" / sub
    assert (p / "speech_shape").read_text() == (j / "speech_shape").read_text()
    assert [ln.split()[0] for ln in (p / "speech_shape").read_text()
            .splitlines()] == ["a", "b", "c", "d", "e"]
    pj, pp = np.load(j / "feats_stats.npz"), np.load(p / "feats_stats.npz")
    assert sorted(pp) == sorted(pj) == ["count", "sum", "sum_square"]
    for k in pj:
        np.testing.assert_array_equal(pp[k], pj[k])


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=STATS_RTOL * scale,
                               err_msg=what)


def test_collect_stats_equals_the_references(tmp_path):
    """The same batches (the port's iterator factory at epoch 1, unshuffled,
    as the pipeline's stage 10 takes them) through both collect_stats; then
    two batches of feature matrices with ``input_feats`` (a stage-3 dump's
    statistics), through both."""
    train, _ = make_mini_corpus(tmp_path / "c", n_train=10, n_dev=1)
    cfg = pasr.load_task_config(None, {
        "exp_dir": str(tmp_path / "exp"),
        "model": {**{k: v for k, v in MODEL.items()}, "frontend": FRONT},
        "data": {**DATA, "train_dir": str(train)}})
    tok, conv, _ = pasr.ASRTask.prepare_vocab(cfg)
    ds = pasr.ASRTask.build_dataset(str(train), tok, conv)
    batches = list(pasr.ASRTask.build_iter_factory(cfg, ds, False)(1))
    assert len(batches) == 2
    for i, b in enumerate(batches):  # ids for the shape file
        b["uids"] = [f"b{i}u{j}" for j in range(len(b["speech"]))]
    got = collect_stats(batches, cfg.model.frontend, tmp_path / "p",
                        device="cpu")
    want = j_collect(batches, JFrontend(**FRONT), tmp_path / "j")
    assert int(got["count"]) == int(want["count"]) > 0
    for k in ("sum", "sum_square"):
        assert got[k].dtype == np.float64
        _close(got[k], np.asarray(want[k]), k)
    saved = np.load(tmp_path / "p" / "feats_stats.npz")
    assert sorted(saved) == ["count", "sum", "sum_square"]
    assert ((tmp_path / "p" / "speech_shape").read_text()
            == (tmp_path / "j" / "speech_shape").read_text())
    # input_feats: the batches' speech is a feature dump, taken as it is.
    rng = np.random.RandomState(1)
    fb = [{"speech": rng.randn(3, 40, 16).astype(np.float32),
           "speech_lengths": np.asarray([40, 31, 9], np.int32),
           "uids": [f"f{i}u{j}" for j in range(3)]} for i in range(2)]
    got = collect_stats(fb, cfg.model.frontend, tmp_path / "pf",
                        input_feats=True, device="cpu")
    want = j_collect(fb, JFrontend(**FRONT), tmp_path / "jf",
                     input_feats=True)
    assert int(got["count"]) == int(want["count"]) == 2 * (40 + 31 + 9)
    for k in ("sum", "sum_square"):
        _close(got[k], np.asarray(want[k]), k)
    assert ((tmp_path / "pf" / "speech_shape").read_text()
            == (tmp_path / "jf" / "speech_shape").read_text())


def _task_cfgs(root, corpus):
    """(reference ASRTaskConfig, port ASRTaskConfig) of the tiny recipe."""
    jcfg = jasr.ASRTaskConfig(
        exp_dir=str(root / "jexp"),
        model=JASRConfig(frontend=JFrontend(**FRONT), **MODEL),
        optim=JOptim(lr=1e-3, scheduler="constant"),
        data=jasr.DataConfig(train_dir=str(corpus[0]),
                             valid_dir=str(corpus[1]), **DATA),
        max_epoch=1, keep_nbest=1, nbest_average=1)
    from espnet_slurp_tpu.utils.config import to_dict as j_to_dict
    d = j_to_dict(jcfg)
    d["exp_dir"] = str(root / "pexp")
    return jcfg, from_dict(pasr.ASRTaskConfig, d)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    corpus = make_mini_corpus(root / "corpus", n_train=10, n_dev=3)
    jcfg, pcfg = _task_cfgs(root, corpus)
    single = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: single)
        jres_ = jpipe.run_pipeline(jcfg, jpipe.PipelineOptions(**OPTS),
                                   stage=1, stop_stage=15)
    # The reference's initial parameters for the same config and seed.
    jtrained = jasr.load_task_config(str(root / "jexp" / "config.yaml"))
    params = jasr.ASRTask.init_params(JaxASRModel(jtrained.model),
                                      jtrained.data.seed)
    init_dir = root / "init"
    init_dir.mkdir()
    torch.save({"params": flax_to_torch(jax.tree.map(np.asarray, params))},
               init_dir / CKPT_FILE)
    import dataclasses
    pcfg = dataclasses.replace(pcfg, init_params_from=str(init_dir))
    pres_ = ppipe.run_pipeline(pcfg, ppipe.PipelineOptions(**OPTS), stage=1,
                               stop_stage=15, device="cpu")
    return dict(root=root, corpus=corpus, j=jres_, p=pres_,
                jexp=root / "jexp", pexp=root / "pexp")


def test_pipeline_runs_every_stage_and_scores(pipelines):
    res, exp = pipelines["p"], pipelines["pexp"]
    assert res["unpack_decode_match"] is True
    assert sorted(res["stage_seconds"]) == [1, 2, 4, 5, 10, 11, 12, 13, 14,
                                            15]
    assert np.isfinite([res["wer_dev"], res["cer_dev"]]).all()
    score = dict(ln.split() for ln in
                 (exp / "decode_dev" / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "WER"]
    sp = (exp / "data" / "train_sp" / "wav.scp").read_text().splitlines()
    assert len(sp) == 20
    assert sum(ln.startswith("sp0.9-train_") for ln in sp) == 10
    s2t = pasr.Speech2Text.from_exp_dir(str(exp), device="cpu")
    assert s2t.mvn_stats is not None
    assert not list(exp.glob("valid.*best"))  # one epoch: nothing averaged
    for name in ("config.yaml", "tokens.txt", "stats/feats_stats.npz",
                 f"1epoch/{CKPT_FILE}"):
        assert (exp / "unpacked" / name).exists(), name
    # the latest epoch's archive carries the latest.json that names it
    assert json.loads((exp / "unpacked" / "latest.json").read_text()) == {
        "epoch": 1}


def test_pipeline_matches_the_references(pipelines):
    jexp, pexp = pipelines["jexp"], pipelines["pexp"]
    assert ((pexp / "tokens.txt").read_text()
            == (jexp / "tokens.txt").read_text())
    js, ps = (np.load(e / "stats" / "feats_stats.npz") for e in (jexp, pexp))
    assert int(ps["count"]) == int(js["count"])
    for k in ("sum", "sum_square"):
        _close(ps[k], js[k], k)
    jh, ph = (json.loads((e / "reporter.json").read_text())["history"]
              for e in (jexp, pexp))
    assert len(jh) == len(ph) == 1
    for je, pe in zip(jh, ph):
        for phase in ("train", "valid"):
            for key in ("loss", "loss_ctc", "loss_att", "acc"):
                np.testing.assert_allclose(
                    pe[phase][key], je[phase][key], rtol=LOSS_RTOL,
                    err_msg=f"epoch {je['epoch']} {phase} {key}")
    assert ((pexp / "decode_dev" / "text").read_text()
            == (jexp / "decode_dev" / "text").read_text())
    j, p = pipelines["j"], pipelines["p"]
    assert p["unpack_decode_match"] is j["unpack_decode_match"] is True
    for k in ("wer_dev", "cer_dev"):
        assert p[k] == pytest.approx(j[k], abs=0)


def test_pack_cli_publishes_fetches_and_decodes(pipelines, tmp_path):
    exp = pipelines["pexp"]
    archive = tmp_path / "m.zip"
    assert p_pack.main(["pack", "--exp_dir", str(exp), "--out",
                        str(archive)]) == 0
    zoo = tmp_path / "zoo"
    assert p_pack.main(["publish", "--archive", str(archive), "--name", "m",
                        "--zoo_dir", str(zoo)]) == 0
    index = json.loads((zoo / "index.json").read_text())
    assert index["m"]["bytes"] == archive.stat().st_size
    out = tmp_path / "fetched"
    assert p_pack.main(["fetch", "--name", "m", "--out_dir", str(out),
                        "--zoo_dir", str(zoo), "--verify_data_dir",
                        str(pipelines["corpus"][1]), "--device", "cpu"]) == 0
    cfg = pasr.load_task_config(str(out / "config.yaml"))
    assert cfg.exp_dir == str(out)
    dev = pipelines["corpus"][1]
    assert (p_pack.verify(out, dev, "cpu")
            == p_pack.verify(exp / "unpacked", dev, "cpu"))
    (zoo / "m.zip").write_bytes(b"changed")
    with pytest.raises(ValueError, match="sha256"):
        p_pack.main(["fetch", "--name", "m", "--out_dir", str(tmp_path / "x"),
                     "--zoo_dir", str(zoo)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_pack.main(["unpack", "--archive", str(archive), "--out_dir",
                         str(tmp_path / "u"), "--verify_data_dir", str(dev)])


@pytest.mark.parametrize("opts,match", [
    ({"feats_type": "fbank_pitch"}, "item 15"),
])
def test_unported_stages_raise_naming_their_item(tmp_path, opts, match):
    cfg = pasr.load_task_config(None, {"exp_dir": str(tmp_path / "exp")})
    with pytest.raises(NotImplementedError, match=match):
        ppipe.run_pipeline(cfg, ppipe.PipelineOptions(**opts), stage=1,
                           stop_stage=15, device="cpu")
    assert not (tmp_path / "exp").exists()


def test_fbank_stage3_and_stats_equal_the_references(tmp_path):
    """feats_type fbank (the case that raised naming queue 1 item 9):
    stages 1-10 of both pipelines on one corpus; stage 3's dumps (the same
    utterances, every [T, 16] matrix within STATS_RTOL of its max |ref|),
    the task each flips to the dump (input_feats, the npy loader, frame
    buckets) and stage 10's collect-stats over the dump, as the
    reference's."""
    corpus = make_mini_corpus(tmp_path / "c", n_train=6, n_dev=2)
    jcfg, pcfg = _task_cfgs(tmp_path, corpus)
    opts = dict(feats_type="fbank")
    jpipe.run_pipeline(jcfg, jpipe.PipelineOptions(**opts), stage=1,
                       stop_stage=10)
    ppipe.run_pipeline(pcfg, ppipe.PipelineOptions(**opts), stage=1,
                       stop_stage=10, device="cpu")
    for split in ("train", "dev"):
        jd, pd = (tmp_path / e / "data" / "fbank" / split
                  for e in ("jexp", "pexp"))
        from espnet_slurp_tpu_torch.data.fileio import read_2column_text
        jf, pf = (read_2column_text(d / "feats.scp") for d in (jd, pd))
        assert sorted(jf) == sorted(pf) and len(pf) > 0
        for uid in pf:
            want, got = np.load(jf[uid]), np.load(pf[uid])
            assert got.shape == want.shape and got.shape[1] == 16
            _close(got, want, uid)
    js, ps = (np.load(tmp_path / e / "stats" / "feats_stats.npz")
              for e in ("jexp", "pexp"))
    assert int(ps["count"]) == int(js["count"]) > 0
    for k in ("sum", "sum_square"):
        _close(ps[k], js[k], k)


def test_train_moe_yaml_runs_through_the_pipeline(tmp_path):
    """conf/train_moe.yaml as written (8 routed experts on every 2nd
    block, moe_aux_weight 0.01, bf16, dropout 0.1, global MVN, warmuplr)
    with only exp_dir, the data dirs, word tokens, sorted batches, one
    epoch and the widths cut to the tiny flagship's overridden: stages
    1-15 on the CPU. Its reporter holds a finite loss_moe_aux beside the
    CTC and attention losses, and the unpacked model decodes as the exp
    dir."""
    import yaml
    corpus = make_mini_corpus(tmp_path / "c", n_train=8, n_dev=2)
    widths = dict(d_model=32, n_head=2, d_ff=64, num_encoder_blocks=2,
                  num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
                  frontend=FRONT)
    over = {"exp_dir": str(tmp_path / "exp"), "max_epoch": 1,
            "model": widths,
            "data": {"train_dir": str(corpus[0]), "valid_dir": str(corpus[1]),
                     **DATA}}
    cfg = pasr.load_task_config("conf/train_moe.yaml", over)
    ref = jasr.load_task_config("conf/train_moe.yaml", over)
    from espnet_slurp_tpu.utils.config import to_dict as j_to_dict
    from espnet_slurp_tpu_torch.utils.config import to_dict
    assert to_dict(cfg) == j_to_dict(ref)
    m = cfg.model
    assert (m.moe_experts, m.moe_every, m.moe_aux_weight, m.dtype,
            m.dropout_rate, m.use_mvn) == (8, 2, 0.01, "bfloat16", 0.1,
                                           "global")
    res = ppipe.run_pipeline(cfg, ppipe.PipelineOptions(decode_beam_size=2,
                                                        decode_max_len=8),
                             stage=1, stop_stage=15, device="cpu")
    assert res["unpack_decode_match"] is True
    assert np.isfinite([res["wer_dev"], res["cer_dev"]]).all()
    hist = json.loads((tmp_path / "exp" / "reporter.json").read_text())
    train = hist["history"][0]["train"]
    for key in ("loss", "loss_ctc", "loss_att", "loss_moe_aux"):
        assert np.isfinite(train[key]), key
    assert train["loss_moe_aux"] >= 1.0  # E * sum density * gate >= 1
    saved = yaml.safe_load((tmp_path / "exp" / "config.yaml").read_text())
    assert saved["model"]["moe_experts"] == 8


def test_pipeline_raises_without_a_card_unless_given_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pipeline would run on it")
    cfg = pasr.load_task_config(None, {"exp_dir": str(tmp_path / "exp")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppipe.run_pipeline(cfg, stage=1, stop_stage=15)


def _copy_exp(pipelines, tmp_path, side):
    """A copy of one pipeline's trained experiment and its config there."""
    import shutil
    src = pipelines[f"{side}exp"]
    dst = tmp_path / f"{side}exp"
    shutil.copytree(src, dst)
    mod = jasr if side == "j" else pasr
    cfg = mod.load_task_config(str(dst / "config.yaml"))
    return dataclasses.replace(cfg, exp_dir=str(dst), data=dataclasses.replace(
        cfg.data, train_dir=str(pipelines["corpus"][0]),
        valid_dir=str(pipelines["corpus"][1])))


def test_lm_and_ngram_stages_match_the_references(pipelines, tmp_path):
    """Stages 7-9 (train_lm, train_ngram) of both pipelines on the corpus:
    the LM experiment's token list and model config equal, one epoch each
    (max_epoch 1), a finite perplexity above 1 (the two LMs start from
    different draws of the same initializers); the stage-9 ARPA byte for
    byte and its .npz cache array for array."""
    cfgs = {side: _copy_exp(pipelines, tmp_path, side) for side in "jp"}
    opts = dict(OPTS, train_lm=True, train_ngram=True)
    single = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: single)
        jres_ = jpipe.run_pipeline(cfgs["j"], jpipe.PipelineOptions(**opts),
                                   stage=7, stop_stage=9)
    pres_ = ppipe.run_pipeline(cfgs["p"], ppipe.PipelineOptions(**opts),
                               stage=7, stop_stage=9, device="cpu")
    assert sorted(pres_["stage_seconds"]) == [7, 8, 9]
    for res in (jres_, pres_):
        assert np.isfinite(res["lm_ppl"]) and res["lm_ppl"] > 1.0
    jexp, pexp = (tmp_path / f"{s}exp" for s in "jp")
    assert ((pexp / "lm" / "tokens.txt").read_text()
            == (jexp / "lm" / "tokens.txt").read_text())
    from espnet_slurp_tpu.tasks.lm import load_lm_config as j_lm_cfg
    from espnet_slurp_tpu_torch.tasks.lm import load_lm_config as p_lm_cfg
    jl, pl = (j_lm_cfg(jexp / "lm" / "config.yaml"),
              p_lm_cfg(pexp / "lm" / "config.yaml"))
    assert dataclasses.asdict(pl.model) == dataclasses.asdict(jl.model)
    assert pl.max_epoch == jl.max_epoch == 1
    hist = json.loads((pexp / "lm" / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1]
    assert ((pexp / "train.arpa").read_bytes()
            == (jexp / "train.arpa").read_bytes())
    a, b = (np.load(e / "train_ngram.npz") for e in (jexp, pexp))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], k)


def test_stage_12_fuses_the_stage_9_ngram_as_the_reference(pipelines,
                                                          tmp_path):
    """Stages 9-13 with train_ngram on copies of the trained experiments
    (stage 10 recollects the stats, stage 11 resumes past max_epoch and
    trains nothing): both decode the dev set with the trigram at
    ngram_weight 0.3 to the same texts and scores."""
    cfgs = {side: _copy_exp(pipelines, tmp_path, side) for side in "jp"}
    opts = dict(OPTS, train_ngram=True, ngram_weight=0.3)
    single = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: single)
        jres_ = jpipe.run_pipeline(cfgs["j"], jpipe.PipelineOptions(**opts),
                                   stage=9, stop_stage=13)
    pres_ = ppipe.run_pipeline(cfgs["p"], ppipe.PipelineOptions(**opts),
                               stage=9, stop_stage=13, device="cpu")
    jexp, pexp = (tmp_path / f"{s}exp" for s in "jp")
    assert ((pexp / "decode_dev" / "text").read_text()
            == (jexp / "decode_dev" / "text").read_text())
    for k in ("wer_dev", "cer_dev"):
        assert pres_[k] == pytest.approx(jres_[k], abs=0)
    assert 9 in pres_["stage_seconds"] and 12 in pres_["stage_seconds"]
