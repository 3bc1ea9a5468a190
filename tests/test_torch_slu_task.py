"""The SLU task's host code, CLIs and recipe through the port on the CPU.

- slu/metrics.py, slu/mini_corpus.py, recipe/prepare_slurp.py (a synthetic
  SLURP release: train/devel/test.jsonl, train_synthetic.jsonl,
  metadata.json), SLUTask.prepare_vocab's token lists and the batches of
  build_iter_factory: equal to the reference's;
- conf/train_slu_tcpgen_gcn.yaml through bin/slu_train --device cpu (only
  exp_dir, the data dirs, max_epoch and micro widths and depths
  overridden), then
  bin/slu_inference with GT transcripts, with a first pass (an ASR
  experiment over the transcripts' words) and with dialogue history:
  score.txt in the reference's format;
- recipe/slu_pipeline.py:run_slu_pipeline stages 1-13 in the shape of
  tests/test_recipe.py::test_slu_pipeline;
- the reference's divergences the port keeps or refuses (ROADMAP.md queue
  3): use_tcpgen builds no TCPGen in an SLU model, data.token_type is not
  read, and a pretrained BERT postdecoder (postdecoder_hf_dir) raises while
  its weights still graft byte for byte.
"""
import json
import os
import shutil
import torch_parity  # noqa: F401  (each test worker's CPU threads)

# transformers (tests only) loads TensorFlow where one is installed: not
# needed here, and seconds to import.
os.environ.setdefault("USE_TF", "0")

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.recipe import prepare_slurp as jprep
from espnet_slurp_tpu.slu import metrics as jmet
from espnet_slurp_tpu.slu import mini_corpus as jmini
from espnet_slurp_tpu.slu import model as jslu
from espnet_slurp_tpu.tasks import slu as jtask
from espnet_slurp_tpu_torch.recipe import prepare_slurp as pprep
from espnet_slurp_tpu_torch.slu import metrics as pmet
from espnet_slurp_tpu_torch.slu import mini_corpus as pmini
from espnet_slurp_tpu_torch.slu import model as pslu
from espnet_slurp_tpu_torch.tasks import slu as ptask
from espnet_slurp_tpu_torch.utils.params import flax_to_torch

YAML = "conf/train_slu_tcpgen_gcn.yaml"
# Micro widths and depths for the CPU (the yaml's: 12 x 256, d_ff 2048, 6
# decoder blocks, BERT 4 x d_ff 1024, deliberation d_ff 1024); the
# frontend, SpecAug and everything else as written.
MICRO = ["model.asr.d_model=32", "model.asr.n_head=2", "model.asr.d_ff=64",
         "model.asr.num_encoder_blocks=2", "model.asr.num_decoder_blocks=1",
         "model.asr.decoder_d_ff=64", "model.text_encoder_blocks=1",
         "model.text_encoder_d_ff=64", "model.deliberation_d_ff=64"]


def _tree(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("slu_corpus")
    return pmini.make_slu_mini_corpus(root / "c", n_train=6, n_dev=3)


def test_metrics_equal_the_references():
    refs = {"a": "play_music SEP song FILL abc SEP play abc",
            "b": "weather_query SEP place FILL Paris SEP weather in paris",
            "c": "calendar_set SEP date FILL monday SEP date FILL monday "
                 "SEP set monday twice",
            "d": ""}
    hyps = {"a": "play_music SEP song FILL abc SEP play abc",
            "b": "calendar_set SEP place FILL paris SEP weather",
            "c": "calendar_set SEP date FILL monday SEP device FILL x",
            "e": "stray"}
    for text in list(refs.values()) + list(hyps.values()):
        assert pmet.parse_entity_text(text) == jmet.parse_entity_text(text)
    assert pmet.intent_accuracy(refs, hyps) == jmet.intent_accuracy(refs,
                                                                    hyps)
    got, want = pmet.slu_f1(refs, hyps), jmet.slu_f1(refs, hyps)
    assert (got.tp, got.fp, got.fn) == (want.tp, want.fp, want.fn) == (
        3, 1, 1)
    assert (got.precision, got.recall, got.f1) == (
        want.precision, want.recall, want.f1)


def test_mini_corpus_equals_the_references(tmp_path):
    pmini.make_slu_mini_corpus(tmp_path / "p", n_train=3, n_dev=2)
    jmini.make_slu_mini_corpus(tmp_path / "j", n_train=3, n_dev=2)
    p, j = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert sorted(p) == sorted(j)
    for name in p:  # wav.scp holds each side's own paths
        if not name.endswith("wav.scp"):
            assert p[name] == j[name], name


def _slurp_release(d):
    """{train,devel,test}.jsonl, train_synthetic.jsonl (a duplicate
    recording and a record without recordings) and metadata.json."""
    d.mkdir()
    rng = np.random.RandomState(0)
    sentences = ["wake me up at five am this week",
                 "olly, play #music by queen.", "what's the weather @ home",
                 "set an alarm for [monday]", "turn the <unk> volume up"]
    annots = ["wake me up at [time : five am] [date : this week]",
              "olly play [artist_name : Queen]", "what's the weather",
              "set an alarm for [date:monday]", "turn the volume up"]
    meta, n = {}, 0
    for subset in ("train", "devel", "test", "train_synthetic"):
        with open(d / f"{subset}.jsonl", "w") as f:
            for i in range(4):
                k = rng.randint(len(sentences))
                recs = [{"file": f"audio-{n + r:04d}.flac"}
                        for r in range(rng.randint(0, 3))]
                if subset == "train_synthetic" and i == 0:
                    recs.append({"file": "audio-0000.flac"})  # seen in train
                n += 3
                rec = {"slurp_id": n, "sentence": sentences[k],
                       "sentence_annotation": annots[k],
                       "scenario": ["alarm", "play", "weather"][k % 3],
                       "action": ["set", "music", "query"][k % 3],
                       "recordings": recs}
                f.write(json.dumps(rec) + "\n")
                meta[str(n)] = {"recordings": {
                    r["file"]: {"usrid": f"u{len(r['file']) % 3}{i}"}
                    for r in recs}}
    (d / "metadata.json").write_text(json.dumps(meta))
    return d


@pytest.mark.parametrize("fmt,synthetic", [("entity", True),
                                           ("intent", False)])
def test_prepare_slurp_equals_the_reference(tmp_path, fmt, synthetic):
    src = _slurp_release(tmp_path / "slurp")
    for text in ("Olly, set @ 5 #tag.  ok", "a <unk> b"):
        assert pprep.clean_transcript(text) == jprep.clean_transcript(text)
    counts = pprep.prepare_slurp(str(src), "/audio", str(tmp_path / "p"),
                                 fmt, synthetic)
    assert counts == jprep.prepare_slurp(str(src), "/audio",
                                         str(tmp_path / "j"), fmt, synthetic)
    assert counts["train"] > 0 and counts["devel"] > 0
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert pprep.main(["--slurp_dir", str(src), "--audio_dir", "/audio",
                       "--out", str(tmp_path / "cli"), "--format", fmt]
                      + ([] if synthetic else ["--no_synthetic"])) == 0
    assert _tree(tmp_path / "cli") == _tree(tmp_path / "p")


def _task_cfgs(tmp_path, corpus, **data):
    d = {"exp_dir": str(tmp_path / "exp"),
         "model": {"two_pass": True, "asr": {"d_model": 32}},
         "data": {"train_dir": str(corpus[0]), "valid_dir": str(corpus[1]),
                  "batch_type": "sorted", "batch_size": 4,
                  "speech_bucket_multiple": 2048,
                  "text_bucket_multiple": 4, **data}}
    jd = json.loads(json.dumps(d))
    jd["exp_dir"] = str(tmp_path / "jexp")
    return ptask.load_slu_config(None, d), jtask.load_slu_config(None, jd)


def test_vocab_and_batches_equal_the_references(tmp_path, corpus):
    """Token lists and resolved model configs as the reference's; with
    data.token_type bpe (the yaml's) both still tokenize by words and
    train no BPE model (ROADMAP.md queue 3). The batches of both epochs'
    iterators are the reference's, array for array."""
    pcfg, jcfg = _task_cfgs(tmp_path, corpus, token_type="bpe",
                            bpe_vocab_size=600)
    ptok, pconv, pextra, pmodel = ptask.SLUTask.prepare_vocab(pcfg)
    jtok, jconv, jextra, jmodel = jtask.SLUTask.prepare_vocab(jcfg)
    for name in ("tokens.txt", "transcript_tokens.txt"):
        assert ((tmp_path / "exp" / name).read_text()
                == (tmp_path / "jexp" / name).read_text()), name
    assert not list((tmp_path / "exp").glob("bpe*"))
    assert type(ptok).__name__ == "WordTokenizer" and pconv.token_list[:2] \
        == ["<blank>", "<unk>"] and "SEP" in pconv.token_list
    assert (pmodel.asr.vocab_size, pmodel.transcript_vocab_size) == (
        jmodel.asr.vocab_size, jmodel.transcript_vocab_size)
    pds = ptask.SLUTask.build_dataset(pcfg, pcfg.data.train_dir, ptok, pconv,
                                      pextra)
    jds = jtask.SLUTask.build_dataset(jcfg, jcfg.data.train_dir, jtok, jconv,
                                      jextra)
    for shuffle in (False, True):
        pit = ptask.SLUTask.build_iter_factory(pcfg, pds, shuffle)
        jit = jtask.SLUTask.build_iter_factory(jcfg, jds, shuffle)
        for epoch in (1, 2):
            pb, jb = list(pit(epoch)), list(jit(epoch))
            assert len(pb) == len(jb) == 2
            for p, j in zip(pb, jb):
                assert sorted(p) == sorted(j) and "transcript" in p
                for k in p:
                    np.testing.assert_array_equal(p[k], np.asarray(j[k]),
                                                  err_msg=k)


def _asr_exp(root, corpus):
    """A first-pass ASR experiment as ASRTask.train leaves one, without
    the training: config.yaml (micro widths, word tokens over the
    transcripts), tokens.txt and the reference's initialisation as the
    n-best average."""
    import dataclasses
    from espnet_slurp_tpu_torch.tasks import asr as pasr
    from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
    from espnet_slurp_tpu_torch.utils.config import save_yaml
    exp = root / "asr_exp"
    text = root / "asr_text"
    text.mkdir()
    shutil.copy(corpus[0] / "transcript", text / "text")
    cfg = pasr.load_task_config(None, {
        "exp_dir": str(exp), "data": {"train_dir": str(text),
                                      "token_type": "word"},
        "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
                  "num_encoder_blocks": 1, "num_decoder_blocks": 1,
                  "decoder_d_ff": 64, "kernel_size": 7}})
    _, _, mcfg = pasr.ASRTask.prepare_vocab(cfg)
    save_yaml(dataclasses.replace(cfg, model=mcfg), exp / "config.yaml")
    model = pasr.ASRTask.init_params(pasr.ASRTask.build_model(
        mcfg, device="cpu"), 0)
    (exp / "valid.loss.ave_1best").mkdir()
    torch.save({"params": model.state_dict()},
               exp / "valid.loss.ave_1best" / CKPT_FILE)
    return exp


def _score(path):
    lines = path.read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["intent_acc", "slu_f1",
                                               "precision", "recall"]
    assert all(len(ln.split()[1].split(".")[1]) == 4 for ln in lines)
    return {k: float(v) for k, v in (ln.split() for ln in lines)}


def test_the_yaml_trains_and_decodes_through_the_slu_clis(tmp_path, corpus):
    from espnet_slurp_tpu_torch.bin import slu_inference, slu_train
    from espnet_slurp_tpu_torch.utils import device as devmod
    exp = tmp_path / "exp"
    assert slu_train.main([
        "--config", YAML, "--set", f"exp_dir={exp}",
        f"data.train_dir={corpus[0]}", f"data.valid_dir={corpus[1]}",
        "max_epoch=1", *MICRO, "--device", "cpu"]) == 0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert len(hist) == 1 and np.isfinite(hist[0]["train"]["loss"])
    cfg = ptask.load_slu_config(str(exp / "config.yaml"))
    m = cfg.model
    assert (m.two_pass, m.postdecoder, m.deliberation_blocks,
            m.asr.use_tcpgen, m.asr.dtype, cfg.optim.scheduler) == (
        True, "bert", 2, True, "bfloat16", "warmuplr")
    asr_exp = _asr_exp(tmp_path, corpus)
    base = ["--exp_dir", str(exp), "--data_dir", str(corpus[1]),
            "--max_len", "8", "--device", "cpu"]
    n_dev = len((corpus[1] / "wav.scp").read_text().splitlines())
    for name, flags in (("gt", ["--use_transcript"]),
                        ("first_pass", ["--asr_exp_dir", str(asr_exp),
                                        "--asr_beam_size", "2"]),
                        ("history", ["--use_transcript", "--use_history"])):
        out = tmp_path / f"dec_{name}"
        syncs = devmod.host_syncs
        assert slu_inference.main(base + ["--output_dir", str(out)]
                                  + flags) == 0
        assert len((out / "text").read_text().splitlines()) == n_dev
        score = _score(out / "score.txt")
        assert 0.0 <= score["intent_acc"] <= 1.0
        assert 0.0 <= score["slu_f1"] <= 1.0
        assert n_dev <= devmod.host_syncs - syncs <= 8 * n_dev, name


def test_clis_raise_without_a_card_unless_asked_for_the_cpu(tmp_path,
                                                             corpus):
    from espnet_slurp_tpu_torch.bin import slu_inference, slu_train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        slu_train.main(["--config", YAML, "--set",
                        f"exp_dir={tmp_path / 'x'}"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        slu_inference.main(["--exp_dir", str(tmp_path), "--data_dir",
                            str(corpus[1]), "--output_dir",
                            str(tmp_path / "d")])


def test_run_slu_pipeline_stages_1_to_13(tmp_path, corpus):
    """tests/test_recipe.py::test_slu_pipeline's shape, through the port."""
    from espnet_slurp_tpu_torch.recipe.slu_pipeline import run_slu_pipeline
    cfg = ptask.load_slu_config(None, {
        "exp_dir": str(tmp_path / "exp"),
        "model": {"two_pass": True, "text_encoder_blocks": 1,
                  "text_encoder_d_ff": 32, "asr": {
                      "d_model": 32, "n_head": 2, "d_ff": 64,
                      "num_encoder_blocks": 1, "num_decoder_blocks": 1,
                      "decoder_d_ff": 64, "kernel_size": 7,
                      "dropout_rate": 0.0, "ctc_weight": 0.3,
                      "frontend": {"n_fft": 128, "hop_length": 64,
                                   "n_mels": 16}, "specaug": None}},
        "optim": {"lr": 1e-3, "scheduler": "constant"},
        "data": {"train_dir": str(corpus[0]), "valid_dir": str(corpus[1]),
                 "batch_type": "sorted", "batch_size": 4,
                 "speech_bucket_multiple": 2048, "text_bucket_multiple": 4},
        "max_epoch": 1, "keep_nbest": 1, "nbest_average": 1})
    results = run_slu_pipeline(cfg, max_len=8, device="cpu")
    assert sorted(results) == ["intent_acc_dev", "slu_f1_dev"]
    assert 0.0 <= results["intent_acc_dev"] <= 1.0
    score = _score(tmp_path / "exp" / "decode_dev" / "score.txt")
    assert score["intent_acc"] == round(results["intent_acc_dev"], 4)
    bad = tmp_path / "bad"
    shutil.copytree(corpus[0], bad)
    (bad / "transcript").unlink()
    import dataclasses
    with pytest.raises(RuntimeError, match="transcript stream"):
        run_slu_pipeline(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, train_dir=str(bad))), stop_stage=1, device="cpu")


def test_use_tcpgen_builds_no_tcpgen_in_an_slu_model():
    """ROADMAP.md queue 3: the reference's SLU losses never call TCPGen, so
    its SLU tree has no TCPGen leaves under use_tcpgen (the yaml's); the
    port's SLU model has the same parameters, while its ASR model alone
    builds TCPGen."""
    from espnet_slurp_tpu.models.asr_model import ASRConfig as JASR
    from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
    asr = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
               num_encoder_blocks=1, num_decoder_blocks=1, decoder_d_ff=64,
               kernel_size=7, use_tcpgen=True, specaug=None)
    kw = dict(two_pass=True, transcript_vocab_size=12, postdecoder="bert",
              text_encoder_blocks=1, text_encoder_d_ff=32,
              deliberation_blocks=1, deliberation_d_ff=32)
    jm = jslu.SLUModel(jslu.SLUConfig(asr=JASR(**asr), **kw))
    b = {"speech": np.zeros((2, 1600), np.float32),
         "speech_lengths": np.asarray([1600, 800], np.int32),
         "text": np.ones((2, 4), np.int32),
         "text_lengths": np.asarray([4, 2], np.int32),
         "transcript": np.ones((2, 5), np.int32),
         "transcript_lengths": np.asarray([5, 3], np.int32)}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), **b)["params"]
    assert "tcpgen" not in shapes["asr"]
    want = {k: tuple(v.shape) for k, v in flax_to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    port = pslu.SLUModel(pslu.SLUConfig(asr=ASRConfig(**asr), **kw),
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert hasattr(ASRModel(ASRConfig(**asr), device="cpu"), "tcpgen")


def test_a_pretrained_bert_postdecoder_grafts_but_raises_in_training(
        tmp_path, corpus):
    """ROADMAP.md queue 3: the reference feeds a pretrained BERT the task's
    word ids (transcript_tokens.txt), not the ids of its WordPiece
    vocabulary. The weights graft byte for byte (as
    tests/test_hf_bridge.py::test_slu_bert_postdecoder_and_grafting holds
    the reference's), the model runs, and SLUTask.train and
    Speech2Understand refuse postdecoder_hf_dir."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    tm = transformers.BertModel(transformers.BertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=24, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).eval()
    tm.save_pretrained(tmp_path / "bert", safe_serialization=False)
    from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
    from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
    cfg = pslu.SLUConfig(
        asr=ASRConfig(vocab_size=30, d_model=16, n_head=2, d_ff=32,
                      num_encoder_blocks=1, num_decoder_blocks=1,
                      decoder_d_ff=32, kernel_size=7, dropout_rate=0.0,
                      frontend=FrontendConfig(n_fft=128, hop_length=64,
                                              n_mels=16), specaug=None),
        two_pass=True, transcript_vocab_size=50, text_encoder_blocks=1,
        text_encoder_d_ff=32, postdecoder="bert",
        postdecoder_hf_dir=str(tmp_path / "bert"))
    model = ptask.SLUTask.load_postdecoder_weights(
        pslu.SLUModel(cfg, device="cpu"), cfg)
    sd = tm.state_dict()
    bert = model.text_encoder.bert
    assert torch.equal(bert.word_embeddings.weight,
                       sd["embeddings.word_embeddings.weight"])
    assert torch.equal(bert.layer_0_q.weight,
                       sd["encoder.layer.0.attention.self.query.weight"])
    rng = np.random.RandomState(0)
    loss, _ = model(
        torch.from_numpy(rng.randn(2, 1600).astype(np.float32) * 0.1),
        torch.tensor([1600, 800]), torch.from_numpy(rng.randint(1, 28, (2, 5))),
        torch.tensor([5, 3]), torch.from_numpy(rng.randint(1, 49, (2, 7))),
        torch.tensor([7, 4]))
    assert np.isfinite(float(loss.detach()))
    # the reference resolves the transcript stream to the task's word list
    pcfg, jcfg = _task_cfgs(tmp_path, corpus)
    _, _, jextra, _ = jtask.SLUTask.prepare_vocab(jcfg)
    words = jextra["transcript"][1].token_list
    assert words[:2] == ["<blank>", "<unk>"] and len(words) != 50
    hf = dict(postdecoder="bert", postdecoder_hf_dir=str(tmp_path / "bert"))
    import dataclasses
    bad = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model,
                                                              **hf))
    with pytest.raises(NotImplementedError, match="queue 3"):
        ptask.SLUTask.train(bad, device="cpu")
    exp = tmp_path / "exp_hf"
    exp.mkdir()
    from espnet_slurp_tpu_torch.utils.config import save_yaml
    save_yaml(dataclasses.replace(bad, exp_dir=str(exp)), exp / "config.yaml")
    with pytest.raises(NotImplementedError, match="queue 3"):
        ptask.Speech2Understand(str(exp), device="cpu")
