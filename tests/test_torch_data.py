"""The port's data pipeline against the reference's: the same corpus, tokens,
batches and scores, exactly (host-side numpy code, copied: every check is
equality, no tolerance)."""
import json
from dataclasses import astuple

import numpy as np
import pytest

from espnet_slurp_tpu.data import mini_corpus as jmc
from espnet_slurp_tpu.data import sampler as jsampler
from espnet_slurp_tpu.data import tokenizer as jtok
from espnet_slurp_tpu.data.fileio import load_wav as j_load_wav
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.utils import metrics as jmetrics
from espnet_slurp_tpu_torch import native
from espnet_slurp_tpu_torch.data import mini_corpus as pmc
from espnet_slurp_tpu_torch.data import sampler as psampler
from espnet_slurp_tpu_torch.data import tokenizer as ptok
from espnet_slurp_tpu_torch.data.fileio import load_wav as p_load_wav
from espnet_slurp_tpu_torch.data.fileio import read_2column_text
from espnet_slurp_tpu_torch.data.prefetch import (prefetch_factory,
                                                  prefetch_to_device)
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.utils import metrics as pmetrics
import torch_parity  # noqa: F401  (each test worker's CPU threads)

TEXTS = ["alpha bravo", "charlie delta echo", "alpha alpha", "golf hotel",
         "india juliet foxtrot", "the quick brown fox", "bravo echo"] * 3


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The mini corpus written by each package from the same seed."""
    root = tmp_path_factory.mktemp("corpora")
    j = jmc.make_mini_corpus(root / "jax", n_train=10, n_dev=3, seed=11)
    p = pmc.make_mini_corpus(root / "port", n_train=10, n_dev=3, seed=11)
    return j, p


def test_mini_corpus_writes_the_same_audio_and_text(corpora):
    for jd, pd in zip(*corpora):
        assert read_2column_text(jd / "text") == read_2column_text(pd / "text")
        jw, pw = (read_2column_text(d / "wav.scp") for d in (jd, pd))
        assert list(jw) == list(pw)
        for uid in jw:
            (ja, jsr), (pa, psr) = j_load_wav(jw[uid]), p_load_wav(pw[uid])
            assert jsr == psr == 16000
            np.testing.assert_array_equal(ja, pa)


@pytest.mark.parametrize("token_type", ["char", "word", "phn"])
def test_tokens_and_token_list_match(token_type):
    jt, pt = jtok.build_tokenizer(token_type), ptok.build_tokenizer(token_type)
    for line in TEXTS:
        assert pt.text2tokens(line) == jt.text2tokens(line)
    jl, pl = (jtok.build_token_list(TEXTS, jt),
              ptok.build_token_list(TEXTS, pt))
    assert pl == jl and pl[0] == "<blank>" and pl[-1] == "<sos/eos>"


def test_phoneme_tokenizer_reads_a_lexicon(tmp_path):
    lex = tmp_path / "lexicon.txt"
    lex.write_text("alpha AE L F AH\nbravo B R AA V OW\n")
    jt = jtok.PhonemeTokenizer(lexicon=str(lex), word_separator="|")
    pt = ptok.PhonemeTokenizer(lexicon=str(lex), word_separator="|")
    for line in ("alpha bravo", "Alpha zulu"):
        assert pt.text2tokens(line) == jt.text2tokens(line)


@pytest.mark.parametrize("marker", ["prefix", "suffix"])
def test_trained_bpe_model_and_its_tokens_match(tmp_path, marker):
    jb = jtok.BpeTokenizer.train(TEXTS, 40, str(tmp_path / "j.json"),
                                 marker=marker)
    pb = ptok.BpeTokenizer.train(TEXTS, 40, str(tmp_path / "p.json"),
                                 marker=marker)
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))
    for line in TEXTS[:7]:
        assert pb.text2tokens(line) == jb.text2tokens(line)
        assert pb.tokens2text(pb.text2tokens(line)) == line


def _shapes(seed=0, n=40):
    rng = np.random.RandomState(seed)
    speech = {f"u{i:03d}": (int(rng.randint(1000, 50000)),) for i in range(n)}
    text = {k: (int(rng.randint(1, 40)),) for k in speech}
    feats = {k: (v[0] // 160, 80) for k, v in speech.items()}
    return speech, text, feats


@pytest.mark.parametrize("batch_type,kw", [
    ("unsorted", dict(batch_size=7)),
    ("sorted", dict(batch_size=7)),
    ("folded", dict(batch_size=8)),
    ("folded", dict(batch_size=8, fold_length=[20000, 20])),
    ("length", dict(batch_bins=200_000)),
    ("length", dict(batch_bins=200_000, batch_size_multiple=4)),
    ("numel", dict(batch_bins=300_000)),
    ("numel", dict(batch_bins=300_000, batch_size_multiple=4,
                   min_batch_size=2)),
    ("numel", dict(batch_bins=300_000, drop_last=True)),
])
def test_build_batches_and_epoch_shuffle_match(batch_type, kw):
    speech, text, feats = _shapes()
    for streams in ([speech, text], [feats, text]):
        jb = jsampler.build_batches(streams, batch_type=batch_type, **kw)
        pb = psampler.build_batches(streams, batch_type=batch_type, **kw)
        assert pb == jb and sum(map(len, pb)) > 0
        for epoch in (1, 2, 3):
            assert (psampler.epoch_shuffle(pb, 5, epoch)
                    == jsampler.epoch_shuffle(jb, 5, epoch))
    cats = {k: "ab"[i % 2] for i, k in enumerate(speech)}
    assert (psampler.build_batches([speech, text], batch_type=batch_type,
                                   utt2category=cats, **kw)
            == jsampler.build_batches([speech, text], batch_type=batch_type,
                                      utt2category=cats, **kw))


def test_shape_files_sharding_and_rounding(tmp_path):
    path = tmp_path / "shape"
    path.write_text("u1 123,80\nu2 7\n")
    assert (psampler.read_shape_file(str(path))
            == jsampler.read_shape_file(str(path)) == {"u1": (123, 80),
                                                        "u2": (7,)})
    batches = [["a", "b", "c", "d"], ["e", "f"]]
    for rank in (0, 1):
        assert (psampler.shard_batches(batches, rank, 2)
                == jsampler.shard_batches(batches, rank, 2))
    with pytest.raises(ValueError):
        psampler.shard_batches([["a"]], 0, 2)
    assert [psampler.round_up(x, 8) for x in (1, 8, 9)] == [
        jsampler.round_up(x, 8) for x in (1, 8, 9)] == [8, 8, 16]


@pytest.mark.parametrize("token_type,batch", [
    ("char", dict(batch_type="numel", batch_bins=60_000)),
    ("word", dict(batch_type="sorted", batch_size=3)),
    ("char", dict(batch_type="length", batch_bins=30_000,
                  batch_size_multiple=2, num_iters_per_epoch=2)),
])
def test_iter_factory_gives_the_references_batches(corpora, tmp_path,
                                                   token_type, batch):
    """ASRTask.build_iter_factory over the same corpus and seed: the same
    utterances in the same order, the same padded shapes and bit-equal
    arrays, in epochs 1 and 2, shuffled (train) and not (valid)."""
    (jtrain, jdev), (ptrain, pdev) = corpora
    data = dict(token_type=token_type, seed=3, speech_bucket_multiple=1024,
                **batch)
    jcfg = jasr.ASRTaskConfig(exp_dir=str(tmp_path / "j"), data=jasr.DataConfig(
        train_dir=str(jtrain), valid_dir=str(jdev), **data))
    pcfg = pasr.ASRTaskConfig(exp_dir=str(tmp_path / "p"), data=pasr.DataConfig(
        train_dir=str(ptrain), valid_dir=str(pdev), **data))
    jt, jc, jm = jasr.ASRTask.prepare_vocab(jcfg)
    pt, pc, pm = pasr.ASRTask.prepare_vocab(pcfg)
    assert pc.token_list == jc.token_list and pm.vocab_size == jm.vocab_size
    for (jd, pd), shuffle in (((jtrain, ptrain), True), ((jdev, pdev), False)):
        jds = jasr.ASRTask.build_dataset(str(jd), jt, jc)
        pds = pasr.ASRTask.build_dataset(str(pd), pt, pc)
        assert pasr.ASRTask.collect_shapes(pds) == \
            jasr.ASRTask.collect_shapes(jds)
        jf = jasr.ASRTask.build_iter_factory(jcfg, jds, shuffle=shuffle)
        pf = pasr.ASRTask.build_iter_factory(pcfg, pds, shuffle=shuffle)
        for epoch in (1, 2):
            jbs, pbs = list(jf(epoch)), list(pf(epoch))
            assert len(pbs) == len(jbs) > 0
            for jb, pb in zip(jbs, pbs):
                assert sorted(pb) == sorted(jb)
                for k in jb:
                    assert pb[k].dtype == jb[k].dtype, k
                    np.testing.assert_array_equal(pb[k], jb[k])
            # the prefetching wrappers give the same batches
            for b, pb in zip(prefetch_factory(pf)(epoch), pbs):
                for k in pb:
                    np.testing.assert_array_equal(b[k], pb[k])
            for b, pb in zip(prefetch_to_device(pf(epoch), "cpu"), pbs):
                for k in pb:
                    np.testing.assert_array_equal(b[k].numpy(), pb[k])


def _score_pairs(seed=0, n=30):
    rng = np.random.RandomState(seed)
    words = ["a", "bb", "ccc", "dd", "e"]
    refs, hyps = {}, {}
    for i in range(n):
        refs[f"u{i}"] = " ".join(rng.choice(words, rng.randint(0, 9)))
        if i % 7 != 3:  # some hypotheses missing
            hyps[f"u{i}"] = " ".join(rng.choice(words, rng.randint(0, 9)))
    return refs, hyps


@pytest.mark.parametrize("unit", ["word", "char"])
def test_error_rate_native_and_python_paths_match(monkeypatch, unit):
    refs, hyps = _score_pairs()
    j_rate, j_stats = jmetrics.error_rate(refs, hyps, unit=unit)
    assert native.edit_stats_batch([[1, 2]], [[1]]) is not None
    p_rate, p_stats = pmetrics.error_rate(refs, hyps, unit=unit)
    monkeypatch.setattr(native, "edit_stats_batch", lambda *a, **k: None)
    py_rate, py_stats = pmetrics.error_rate(refs, hyps, unit=unit)
    assert astuple(p_stats) == astuple(py_stats) == astuple(j_stats)
    assert p_rate == py_rate == j_rate and p_stats.ref_len > 0
    for r, h in (("a b c", "a x c d"), ("", "a"), ("a", "")):
        assert (astuple(pmetrics.align_stats(r.split(), h.split()))
                == astuple(jmetrics.align_stats(r.split(), h.split())))
