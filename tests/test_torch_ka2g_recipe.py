"""recipe/ka2g_run.py, recipe/results_run.py and tasks/generic.py on the CPU.

- make_ka2g_corpus and make_synth_corpus write the reference's files from
  the same seed, byte for byte (wav.scp's paths up to the root);
- the slot streams, the vocabulary and the forest equal the reference's;
- run_training: a two-step run of a tiny KA2G model over resident speech
  writes its checkpoints and reporter, and resumes; a mesh raises;
- simple_iter_factory: the reference's batches;
- the recipe's CLI end to end at micro widths (``build_cfg`` swapped for a
  tiny config): three arms, results.json, RESULTS_KA2G.md, exit code 0
  or 1 (the F1 of a one-epoch model is not judged).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data import dataset as jds
from espnet_slurp_tpu.recipe import ka2g_run as jrun
from espnet_slurp_tpu.recipe import results_run as jres
from espnet_slurp_tpu.slu import generator as jgen
from espnet_slurp_tpu.tasks import generic as jgeneric
from espnet_slurp_tpu_torch.data import dataset as pds
from espnet_slurp_tpu_torch.data.fileio import read_2column_text
from espnet_slurp_tpu_torch.data.resident import ResidentCorpus
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.recipe import ka2g_run as prun
from espnet_slurp_tpu_torch.recipe import results_run as pres
from espnet_slurp_tpu_torch.slu import generator as pgen
from espnet_slurp_tpu_torch.slu.ka2g import KA2GConfig, KA2GModel
from espnet_slurp_tpu_torch.tasks import generic as pgeneric
from espnet_slurp_tpu_torch.tasks.asr import ASRTask
from espnet_slurp_tpu_torch.train.optim import OptimConfig
import torch_parity  # noqa: F401  (each test worker's CPU threads)


def _files(root: Path):
    out = {}
    for f in sorted(root.rglob("*")):
        if f.is_file():
            out[str(f.relative_to(root))] = f.read_bytes().replace(
                str(root).encode(), b"<root>")
    return out


@pytest.fixture(scope="module")
def ka2g_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ka2g")
    got = prun.make_ka2g_corpus(root / "port", n_train=10, n_dev=5,
                                n_test=5)
    want = jrun.make_ka2g_corpus(root / "ref", n_train=10, n_dev=5,
                                 n_test=5)
    return root, got, want


def test_ka2g_corpus_equals_the_references(ka2g_corpus):
    root, got, want = ka2g_corpus
    assert got[3] == want[3]  # the ontology
    pf, jf = _files(root / "port"), _files(root / "ref")
    assert sorted(pf) == sorted(jf)
    assert len([k for k in pf if k.endswith(".wav")]) == 20
    for k in pf:
        assert pf[k] == jf[k], k
    # reuse returns the same dirs without rewriting
    again = prun.make_ka2g_corpus(root / "port")
    assert again[3] == got[3] and again[0] == got[0]


def test_synth_corpus_equals_the_references(tmp_path):
    got = pres.make_synth_corpus(tmp_path / "port", n_train=4, n_dev=2,
                                 n_test=2, vocab_size=20)
    jres.make_synth_corpus(tmp_path / "ref", n_train=4, n_dev=2, n_test=2,
                           vocab_size=20)
    assert [p.name for p in got] == ["train", "dev", "test"]
    pf, jf = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(pf) == sorted(jf) and len(pf) == 8 + 6
    for k in pf:
        assert pf[k] == jf[k], k
    assert pres.N_UNITS == jres.N_UNITS
    rng_p, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(pres._unit_wave(7, 1.1, 900, 16000, rng_p),
                                  jres._unit_wave(7, 1.1, 900, 16000, rng_j))


def test_slot_streams_vocab_and_forest_equal_the_references(ka2g_corpus):
    _, (train, _, _, onto), _ = ka2g_corpus
    texts = read_2column_text(Path(train) / "text")
    slots = read_2column_text(Path(train) / "slots")
    tokens = prun.build_vocab(texts, onto)
    vocab = sorted({w for t in texts.values() for w in t.split()}
                   | {w for sv in onto for v in sv for w in v})
    assert tokens == ["<blank>", "<unk>"] + vocab + ["<eos>"]
    tok2id = {t: i for i, t in enumerate(tokens)}
    for u, line in slots.items():
        assert prun._parse_slots(line) == jrun._parse_slots(line)
        for a, b in zip(prun._slot_arrays(line, tok2id),
                        jrun._slot_arrays(line, tok2id)):
            np.testing.assert_array_equal(a, b)
    ids = [[[tok2id[w] for w in v] for v in sv] for sv in onto]
    tp, rp = pgen.build_ontology_forest(ids)
    tj, rj = jgen.build_ontology_forest(ids)
    np.testing.assert_array_equal(rp, rj)
    for k, v in prun.forest_arrays(tp).items():
        np.testing.assert_array_equal(v, getattr(tj, {
            "trie_token": "token", "trie_children_tok": "children_tok",
            "trie_children_node": "children_node",
            "trie_n_children": "n_children"}[k]))


_BUILD_CFG = prun.build_cfg


def tiny_cfg(vocab_size: int, use_tcpgen: bool) -> KA2GConfig:
    """The recipe's model at micro widths (the CPU's stand-in for
    ka2g_run.build_cfg)."""
    full = _BUILD_CFG(vocab_size, use_tcpgen)
    return KA2GConfig(
        asr=ASRConfig(vocab_size=vocab_size, d_model=16, n_head=2, d_ff=32,
                      num_encoder_blocks=1, num_decoder_blocks=1,
                      decoder_d_ff=16, kernel_size=3, dropout_rate=0.1,
                      ctc_weight=1.0, use_mvn="utterance",
                      specaug=full.asr.specaug,
                      frontend=FrontendConfig(n_fft=128, hop_length=64,
                                              n_mels=16)),
        gen=dataclasses.replace(full.gen, d_model=16, n_head=2, d_ff=32,
                                num_blocks=1, dtype="float32"))


def test_run_training_two_steps_write_checkpoints(ka2g_corpus, tmp_path):
    _, (train, dev, _, onto), _ = ka2g_corpus
    tokens = prun.build_vocab(read_2column_text(Path(train) / "text"), onto)
    tok2id = {t: i for i, t in enumerate(tokens)}
    trie, roots = pgen.build_ontology_forest(
        [[[tok2id[w] for w in v] for v in sv] for sv in onto])
    rc = ResidentCorpus.from_datadirs([str(train), str(dev)], workers=2,
                                      device="cpu")
    fac = lambda d, shuffle: prun.make_factory(rc, d, tok2id, 4, True,
                                               shuffle, trie, roots)
    batches = list(fac(train, True)(1))
    assert len(batches) == 2  # 10 utterances in batches of 4
    assert batches[0]["node"].shape == (4, prun.N_SLOTS * prun.VALUE_LEN)
    model = KA2GModel(tiny_cfg(len(tokens), True), device="cpu")
    run = pgeneric.RunOptions(max_epoch=1, keep_nbest=1, log_interval=1)
    kw = dict(exp_dir=str(tmp_path / "exp"), model=model,
              train_factory=fac(train, True), valid_factory=fac(dev, False),
              optim=OptimConfig(scheduler="constant", lr=1e-3), run=run)
    state = pgeneric.run_training(
        init_fn=lambda m, seed: ASRTask.init_params(m, seed), **kw)
    assert int(state.step) == 2
    exp = tmp_path / "exp"
    assert (exp / "1epoch").is_dir()
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert np.isfinite(hist[0]["train"]["loss"])
    assert {"loss_ptr", "loss_ctc", "slot_acc"} <= set(hist[0]["train"])
    # a second call resumes past max_epoch and takes no step
    state = pgeneric.run_training(**kw)
    assert int(state.step) == 2
    with pytest.raises(NotImplementedError, match="item 17"):
        pgeneric.run_training(mesh=object(), **kw)


def test_simple_iter_factory_equals_the_references(ka2g_corpus):
    _, (train, _, _, _), _ = ka2g_corpus
    streams = [(str(Path(train) / "wav.scp"), "speech", "sound")]
    adapter = lambda uids, coll: dict(coll, uids=np.asarray(uids))
    got = list(pgeneric.simple_iter_factory(
        pds.SpeechDataset(streams), adapter, 3, 1, True,
        bucket_multiples={"speech": 1024})(2))
    want = list(jgeneric.simple_iter_factory(
        jds.SpeechDataset(streams), adapter, 3, 1, True,
        bucket_multiples={"speech": 1024})(2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_the_recipe_cli_at_micro_widths(ka2g_corpus, tmp_path, monkeypatch):
    root, _, _ = ka2g_corpus
    monkeypatch.setattr(prun, "build_cfg", tiny_cfg)
    out = tmp_path / "out"
    rc = prun.main(["--out", str(out), "--corpus", str(root / "port"),
                    "--max_epoch", "1", "--batch_size", "4",
                    "--eval_batch", "5", "--device", "cpu"])
    assert rc in (0, 1)
    results = json.loads((out / "results.json").read_text())
    assert sorted(results) == ["nokb", "tcpgen_forest", "tcpgen_noforest"]
    for r in results.values():
        assert sorted(r) == ["f1", "precision", "rare_recall", "recall"]
    md = (out / "RESULTS_KA2G.md").read_text()
    assert "| tcpgen_forest |" in md and "| nokb |" in md
    for arm in ("nokb", "tcpgen"):
        assert (out / f"exp_{arm}" / "1epoch").is_dir()
    # cached arms are not retrained
    assert prun.main(["--out", str(out), "--corpus", str(root / "port"),
                      "--device", "cpu"]) == rc
    if not torch.cuda.is_available():  # no card, no --device: raises
        with pytest.raises(RuntimeError, match="CUDA"):
            prun.main(["--out", str(out), "--corpus", str(root / "port")])
