"""The port's streaming recognizers and streaming CLI against the JAX
package, on the CPU.

- decode/streaming.py:StreamingRecognizer (re-encode) and
  decode/incremental.py:IncrementalRecognizer against the reference's on
  the same converted weights (2 blocks x 32, chunk 4, left 1, kernel 7,
  n_fft 128 / hop 64 / 16 mels, the reference's flash "off"): every
  partial hypothesis and the final one (beam 2 and greedy) equal.
- decode/streaming.py:StreamingTransducerRecognizer against the
  reference's (a one-block chunked Conformer-transducer, its joint
  sharpened so that the decodes emit labels): greedy partials, and the
  final pass by greedy, ALSA and mAES, equal.
- bin/asr_inference_streaming with and without ``--incremental`` on a
  chunked micro model that the port's bin/asr_train trains one epoch:
  text, chunk_ms.json and score.txt; each mode's text is its recognizer's,
  and the two modes' final texts are equal (fp32).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.decode import incremental as jinc
from espnet_slurp_tpu.decode import streaming as jstream
from espnet_slurp_tpu.models import transducer as jtd
from espnet_slurp_tpu.models.asr_model import ASRConfig as JaxASRConfig
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JaxFrontend
from espnet_slurp_tpu_torch.bin import asr_inference_streaming as p_stream
from espnet_slurp_tpu_torch.bin import asr_train as p_train
from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
from espnet_slurp_tpu_torch.decode.incremental import IncrementalRecognizer
from espnet_slurp_tpu_torch.decode.streaming import (
    StreamingRecognizer, StreamingTransducerRecognizer)
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.models.transducer import (TransducerConfig,
                                                      TransducerModel)
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
ASR = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
           num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
           dropout_rate=0.0, ctc_weight=0.3, chunk_size=4, left_chunks=1,
           use_mvn="none", specaug=None)
CHUNK = 1600


@pytest.fixture(scope="module")
def asr_models():
    """(flax model, numpy params, port model): 2 chunked blocks."""
    jm = JaxASRModel(JaxASRConfig(**ASR, num_encoder_blocks=2,
                                  flash_attention="off",
                                  frontend=JaxFrontend(**FRONT)))
    wav = (0.1 * np.random.RandomState(0).randn(1, 4000)).astype(np.float32)
    params = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray([4000]),
        jnp.ones((1, 3), jnp.int32), jnp.asarray([3]))["params"])
    # a CTC head that emits labels, so that the partials are not empty
    params["ctc"]["kernel"] = params["ctc"]["kernel"] * 6.0
    params["ctc"]["bias"][0] = -1.0
    pm = ASRModel(ASRConfig(**ASR, num_encoder_blocks=2,
                            frontend=FrontendConfig(**FRONT)), device="cpu")
    pm.load_state_dict(flax_to_torch(params))
    return jm, params, pm


def _run(rec, wav, n=CHUNK):
    """Every call's (ids, done) over the stream."""
    out = []
    for off in range(0, len(wav), n):
        ids, done = rec(wav[off:off + n], is_final=off + n >= len(wav))
        out.append(([int(i) for i in ids], done))
    return out


@pytest.mark.parametrize("beam", [2, 1])
@pytest.mark.parametrize("incremental", [False, True])
def test_recognizer_partials_and_final_equal_the_reference(asr_models, beam,
                                                           incremental):
    jm, params, pm = asr_models
    wav = (0.1 * np.random.RandomState(6).randn(4400)).astype(np.float32)
    kw = dict(chunk_samples=CHUNK, max_len=8, beam_size=beam)
    if incremental:
        want = _run(jinc.IncrementalRecognizer(jm, params, **kw), wav)
        got = _run(IncrementalRecognizer(pm, **kw), wav)
    else:
        want = _run(jstream.StreamingRecognizer(jm, params, **kw), wav)
        got = _run(StreamingRecognizer(pm, **kw), wav)
    assert got == want
    assert got[-1][1] and not any(done for _, done in got[:-1])
    assert any(ids for ids, _ in got[:-1])  # partials with labels


def test_streaming_needs_a_chunked_model():
    pm = ASRModel(ASRConfig(**{**ASR, "chunk_size": 0},
                            frontend=FrontendConfig(**FRONT)), device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        StreamingRecognizer(pm)
    with pytest.raises(ValueError, match="chunk_size"):
        IncrementalRecognizer(pm)


HEAD = dict(pred_dim=24, joint_dim=40, aux_ctc_weight=0.3)
TR_ASR = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
              num_encoder_blocks=1, kernel_size=7, dropout_rate=0.0,
              chunk_size=4, left_chunks=1, specaug=None)


@pytest.mark.parametrize("search,beam", [("greedy", 1), ("alsa", 3),
                                         ("maes", 3)])
def test_transducer_recognizer_equals_the_reference(search, beam):
    jm = jtd.TransducerModel(jtd.TransducerConfig(
        asr=JaxASRConfig(**TR_ASR, flash_attention="off",
                         frontend=JaxFrontend(**FRONT)), **HEAD))
    params = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(1), np.zeros((1, 2400), np.float32),
        np.asarray([2400], np.int32), np.ones((1, 3), np.int32),
        np.asarray([3], np.int32))["params"])
    params["joint"]["lin_out"]["kernel"] *= 3.0
    params["joint"]["lin_pred"]["kernel"] *= 4.0
    params["joint"]["lin_out"]["bias"][0] += 2.0
    pm = TransducerModel(TransducerConfig(
        asr=ASRConfig(**TR_ASR, frontend=FrontendConfig(**FRONT)), **HEAD),
        device="cpu")
    pm.load_state_dict(flax_to_torch(params))
    wav = (0.1 * np.random.RandomState(8).randn(4400)).astype(np.float32)
    kw = dict(chunk_samples=CHUNK, max_len=10, beam_size=beam, search=search)
    want = _run(jstream.StreamingTransducerRecognizer(jm, params, **kw), wav)
    got = _run(StreamingTransducerRecognizer(pm, **kw), wav)
    assert got == want
    assert got[-1][0]  # the final pass emits labels


@pytest.fixture(scope="module")
def streaming_exp(tmp_path_factory):
    """A chunked micro model (1 block x 32, chunk 4, left 1) trained one
    epoch by the port's bin/asr_train on a 6 + 3 utterance mini corpus."""
    root = tmp_path_factory.mktemp("stream")
    corpus = make_mini_corpus(root / "corpus", n_train=6, n_dev=3)
    cfg = {"exp_dir": str(root / "exp"), "max_epoch": 1,
           "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
                     "num_encoder_blocks": 1, "num_decoder_blocks": 1,
                     "decoder_d_ff": 64, "kernel_size": 7,
                     "dropout_rate": 0.0, "specaug": None, "use_mvn": "none",
                     "chunk_size": 4, "left_chunks": 1,
                     "frontend": FRONT},
           "optim": {"scheduler": "constant", "lr": 1e-3},
           "data": {"token_type": "word", "batch_type": "sorted",
                    "train_dir": str(corpus[0]),
                    "valid_dir": str(corpus[1])}}
    (root / "s.yaml").write_text(yaml.safe_dump(cfg))
    assert p_train.main(["--config", str(root / "s.yaml"),
                         "--device", "cpu"]) == 0
    return root / "exp", corpus[1]


@pytest.mark.parametrize("incremental", [False, True])
def test_streaming_cli_on_the_cpu(streaming_exp, tmp_path, incremental):
    exp, dev = streaming_exp
    out = tmp_path / "dec"
    flags = ["--incremental"] if incremental else []
    assert p_stream.main(["--exp_dir", str(exp), "--data_dir", str(dev),
                          "--output_dir", str(out), "--beam_size", "2",
                          "--max_len", "6", "--sim_chunk_length", "2048",
                          "--print_partial", "--device", "cpu",
                          *flags]) == 0
    got = dict((line.split(" ", 1) + [""])[:2]
               for line in (out / "text").read_text().splitlines())
    s2t = Speech2Text.from_exp_dir(str(exp), device="cpu", max_len=6,
                                   beam_size=2)
    cls = IncrementalRecognizer if incremental else StreamingRecognizer
    rec = cls(s2t.model, tokenizer=s2t.tokenizer, converter=s2t.converter,
              chunk_samples=2048, max_len=6, beam_size=2)
    wavs = read_2column_text(dev / "wav.scp")
    want = {uid: rec.text(_run(rec, load_wav(p)[0], 2048)[-1][0])
            for uid, p in wavs.items()}
    assert got == want
    chunk_ms = json.loads((out / "chunk_ms.json").read_text())
    assert sorted(chunk_ms) == sorted(wavs)
    assert all(len(v) >= 1 and min(v) > 0 for v in chunk_ms.values())
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]
    other = tmp_path / "other"
    assert p_stream.main(["--exp_dir", str(exp), "--data_dir", str(dev),
                          "--output_dir", str(other), "--beam_size", "2",
                          "--max_len", "6", "--sim_chunk_length", "2048",
                          "--device", "cpu",
                          *([] if incremental else ["--incremental"])]) == 0
    assert (other / "text").read_text() == (out / "text").read_text()
