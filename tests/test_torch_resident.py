"""data/resident.py, the dataset additions, data/chunk_iter.py and the
``data.resident_corpus`` path of tasks/asr.py, against the reference's and
the host pipeline's, on the CPU (``device="cpu"``):

- ResidentCorpus.speech: bit-equal to data/fileio.load_wav (and to the
  reference's gather), zero past each length, lengths on the host;
- SpeechDataset.item_without, IterableSpeechDataset and
  chunk_iter_factory: the reference's items and batches;
- ASRTask.build_iter_factory with a materializer: every batch equal to the
  host pipeline's (speech included, bit for bit); ASRTask.train with
  ``data.resident_corpus`` trains and checkpoints, and refuses non-raw
  features with the reference's ValueError.
"""
import dataclasses

import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data import chunk_iter as jchunk
from espnet_slurp_tpu.data import dataset as jds
from espnet_slurp_tpu.data.resident import ResidentCorpus as JResident
from espnet_slurp_tpu_torch.data import chunk_iter as pchunk
from espnet_slurp_tpu_torch.data import dataset as pds
from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
from espnet_slurp_tpu_torch.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu_torch.data.resident import ResidentCorpus
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.tasks.asr import (ASRTask, ASRTaskConfig,
                                              DataConfig)
from espnet_slurp_tpu_torch.train.optim import OptimConfig
import torch_parity  # noqa: F401  (each test worker's CPU threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_mini_corpus(tmp_path_factory.mktemp("res") / "c",
                            n_train=6, n_dev=3)


def test_speech_is_bit_equal_to_load_wav_and_the_reference(corpus):
    train, _ = corpus
    scp = read_2column_text(train / "wav.scp")
    rc = ResidentCorpus(scp, workers=2, device="cpu")
    assert rc.buffer.dtype == torch.int16 and rc.buffer.shape[1] == 128
    uids = sorted(scp)[1:5]
    host = [load_wav(scp[u])[0] for u in uids]
    t_pad = -(-(max(len(x) for x in host) + 37) // 128) * 128
    speech, lens = rc.speech(uids, t_pad)
    assert isinstance(lens, np.ndarray) and lens.dtype == np.int32
    np.testing.assert_array_equal(lens, [len(x) for x in host])
    assert speech.dtype == torch.float32 and speech.shape == (4, t_pad)
    got = speech.numpy()
    for i, x in enumerate(host):
        np.testing.assert_array_equal(got[i, :len(x)], x)
        assert np.all(got[i, len(x):] == 0.0)
    ref, ref_lens = JResident(scp, workers=2).speech(uids, t_pad)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(lens, ref_lens)
    # a pad that is not a multiple of the row rounds up; too short raises
    assert rc.speech(uids, t_pad - 5)[0].shape == (4, t_pad)
    with pytest.raises(ValueError):
        rc.speech(uids, 4)
    assert rc.materializer() == rc.speech
    rc2 = ResidentCorpus.from_datadirs([str(train)], workers=2, device="cpu")
    assert rc2.index == rc.index


def _streams(d):
    return [(str(d / "wav.scp"), "speech", "sound"),
            (str(d / "text"), "text", "text")]


def test_item_without_and_iterable_dataset_equal_the_references(corpus):
    train, _ = corpus
    p, j = pds.SpeechDataset(_streams(train)), \
        jds.SpeechDataset(_streams(train))
    for i in (0, 3, p.keys[5]):
        (pu, pd), (ju, jd) = p.item_without(i), j.item_without(i)
        assert pu == ju and sorted(pd) == sorted(jd) == ["text"]
        assert pd["text"] == jd["text"]
        pu, pd = p.item_without(i, skip=())
        assert sorted(pd) == ["speech", "text"]
    pit = list(pds.IterableSpeechDataset(_streams(train)))
    jit = list(jds.IterableSpeechDataset(_streams(train)))
    assert [u for u, _ in pit] == [u for u, _ in jit]
    for (_, a), (_, b) in zip(pit, jit):
        np.testing.assert_array_equal(a["speech"], b["speech"])
        assert a["text"] == b["text"]
    # streams out of order raise
    bad = train.parent / "bad_text"
    lines = (train / "text").read_text().splitlines()
    bad.write_text("\n".join(lines[1:] + lines[:1]) + "\n")
    with pytest.raises(RuntimeError, match="order"):
        list(pds.IterableSpeechDataset(
            [(str(train / "wav.scp"), "speech", "sound"),
             (str(bad), "text", "text")]))


@pytest.mark.parametrize("shuffle,excess", [(True, "drop"),
                                            (False, "pad")])
def test_chunk_iter_factory_equals_the_reference(corpus, shuffle, excess):
    train, _ = corpus
    rng = np.random.RandomState(0)
    ds_p = pds.SpeechDataset(_streams(train))
    labels = {u: rng.randint(0, 5, 100).astype(np.int32)
              for u in ds_p.keys}

    class WithLabels:
        def __init__(self, ds):
            self.ds, self.keys = ds, ds.keys

        def __getitem__(self, uid):
            u, d = self.ds[uid]
            return u, {**d, "frames": labels[u]}

    kw = dict(chunk_length=1280, batch_size=3, seed=2, shuffle=shuffle,
              aligned=("frames",), aligned_ratio={"frames": 1 / 64},
              excess_mode=excess)
    got = list(pchunk.chunk_iter_factory(WithLabels(ds_p), **kw)(1))
    want = list(jchunk.chunk_iter_factory(
        WithLabels(jds.SpeechDataset(_streams(train))), **kw)(1))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["frames", "speech",
                                          "speech_lengths"]
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
        assert g["frames"].shape == (3, 20)


def _task_cfg(tmp_path, train, dev, **data):
    return ASRTaskConfig(
        exp_dir=str(tmp_path / "exp"),
        model=ASRConfig(d_model=16, n_head=2, d_ff=32, num_encoder_blocks=1,
                        num_decoder_blocks=1, decoder_d_ff=32,
                        kernel_size=3, use_mvn="none", specaug=None,
                        frontend=FrontendConfig(n_fft=128, hop_length=64,
                                                n_mels=16)),
        optim=OptimConfig(scheduler="constant", lr=1e-3),
        data=DataConfig(train_dir=str(train), valid_dir=str(dev),
                        token_type="word", batch_type="sorted",
                        batch_size=3, **data),
        max_epoch=1, keep_nbest=1, nbest_average=1)


def test_resident_batches_equal_the_host_pipelines(corpus, tmp_path):
    train, dev = corpus
    cfg = _task_cfg(tmp_path, train, dev, resident_corpus=True)
    tok, conv, _ = ASRTask.prepare_vocab(cfg)
    ds = ASRTask.build_dataset(str(train), tok, conv)
    rc = ResidentCorpus.from_datadirs([str(train)], device="cpu")
    for shuffle in (False, True):
        plain = list(ASRTask.build_iter_factory(cfg, ds, shuffle)(2))
        res = list(ASRTask.build_iter_factory(
            cfg, ds, shuffle, speech_materializer=rc.materializer())(2))
        assert len(plain) == len(res) == 2
        for a, b in zip(plain, res):
            assert sorted(a) == sorted(b)
            assert isinstance(b["speech"], torch.Tensor)
            np.testing.assert_array_equal(b["speech"].numpy(), a["speech"])
            for k in a:
                if k != "speech":
                    np.testing.assert_array_equal(b[k], a[k])


def test_train_with_a_resident_corpus(corpus, tmp_path):
    train, dev = corpus
    cfg = _task_cfg(tmp_path, train, dev, resident_corpus=True,
                    resident_workers=2)
    ASRTask.train(cfg, device="cpu")
    exp = tmp_path / "exp"
    assert (exp / "1epoch").is_dir() and (exp / "reporter.json").exists()
    bad = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, feats_type="fbank"))
    with pytest.raises(ValueError, match="raw-audio"):
        ASRTask.train(bad, device="cpu")
