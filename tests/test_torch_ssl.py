"""The SSL feature path (``feats_type: ssl``): the ASR model's learned
softmax weighting of a [B, T, L, D] layer dump (``ssl_num_layers``)
against the reference's, and the dump -> train -> decode pipeline through
the port's CLIs (bin/ssl_dump, bin/asr_train, bin/asr_inference, all with
``--device cpu``), as the reference's tests/test_ssl_frontend.py drives its
own; ``--torch_ckpt`` with ``--layer k`` against ``transformers``."""
import json

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.models import asr_model as jasr_model
from espnet_slurp_tpu_torch.bin import asr_inference, asr_train, ssl_dump
from espnet_slurp_tpu_torch.data.fileio import read_2column_text
from espnet_slurp_tpu_torch.models import asr_model as pasr_model
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import assert_grads_match, t

SSL = dict(vocab_size=11, d_model=16, n_head=2, d_ff=32,
           num_encoder_blocks=1, num_decoder_blocks=1, decoder_d_ff=32,
           kernel_size=7, dropout_rate=0.0, input_feats=True,
           input_feats_dim=12, ssl_num_layers=3, use_mvn="utterance",
           specaug=None, flash_attention="off")


def test_layer_weighting_loss_and_gradients_match_the_reference():
    """Three layers weighted by softmax(ssl_layer_weights), then MVN over
    the weighted features: the loss, stats and every gradient (the layer
    weights' included) against the reference's, at unequal lengths."""
    rng = np.random.RandomState(0)
    data = {
        "speech": rng.randn(2, 40, 3, 12).astype(np.float32),
        "speech_lengths": np.asarray([40, 31], np.int32),
        "text": np.asarray([[1, 2, 3], [4, 5, -1]], np.int32),
        "text_lengths": np.asarray([3, 2], np.int32),
    }
    jmodel = jasr_model.ASRModel(jasr_model.ASRConfig(**SSL))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), **data)["params"])
    # away from the zero init, so that the weighting is not a plain mean
    params["ssl_layer_weights"] = np.asarray([0.5, -0.3, 0.1], np.float32)
    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, train=True, **data),
        has_aux=True))(params)
    port = pasr_model.ASRModel(pasr_model.ASRConfig(**SSL), device="cpu")
    port.load_state_dict(flax_to_torch(params))
    loss, stats = port(**{k: t(v) for k, v in data.items()}, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(port.ssl_layer_weights.grad.abs().sum()) > 0
    assert_grads_match(port.named_parameters(), ref_g, 1e-3)


def test_ssl_num_layers_needs_a_feature_dump():
    cfg = pasr_model.ASRConfig(**dict(SSL, input_feats=False))
    with pytest.raises(ValueError, match="input_feats"):
        pasr_model.ASRModel(cfg, device="cpu")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """bin/ssl_dump (--layer -1, seeded weights at d_model 32, 2 blocks)
    of a mini corpus's train and dev splits."""
    root = tmp_path_factory.mktemp("ssl")
    train_dir, dev_dir = make_mini_corpus(root / "c", n_train=8, n_dev=3)
    for split, d in (("train", train_dir), ("dev", dev_dir)):
        assert ssl_dump.main([
            "--data_dir", str(d), "--out_dir", str(root / "dump" / split),
            "--d_model", "32", "--num_blocks", "2", "--n_head", "2",
            "--d_ff", "64", "--layer", "-1", "--device", "cpu"]) == 0
    return root


def test_ssl_dump_train_decode_pipeline(dumps, tmp_path):
    """The reference test's pipeline: every dumped matrix [T, 3, 32] with
    the text carried over; feats_type ssl training with the layer
    weighting and the linear pre-encoder, two epochs; the decode straight
    from feats.scp, equal to Speech2Text's on the dumped matrices, which
    refuses waveforms."""
    dev = dumps / "dump" / "dev"
    mats = sorted((dumps / "dump" / "train" / "data").glob("*.npy"))
    assert len(mats) == 8
    for m in mats:
        a = np.load(m)
        assert a.ndim == 3 and a.shape[1:] == (3, 32) and a.shape[0] > 0
    assert set(read_2column_text(dev / "text")) == set(
        read_2column_text(dev / "feats.scp"))
    exp = tmp_path / "exp_ssl"
    (tmp_path / "train.yaml").write_text(f"""
exp_dir: {exp}
max_epoch: 2
model:
  d_model: 16
  n_head: 2
  d_ff: 32
  num_encoder_blocks: 1
  num_decoder_blocks: 1
  decoder_d_ff: 32
  kernel_size: 7
  input_feats: true
  input_feats_dim: 32
  ssl_num_layers: 3
  preencoder: linear
  preencoder_dim: 32
  use_mvn: none
  specaug: null
  flash_attention: "off"
data:
  train_dir: {dumps / 'dump' / 'train'}
  valid_dir: {dev}
  feats_type: ssl
  token_type: word
  batch_type: sorted
  batch_size: 4
  speech_bucket_multiple: 16
""")
    assert asr_train.main(["--config", str(tmp_path / "train.yaml"),
                           "--device", "cpu"]) == 0
    rep = json.loads((exp / "reporter.json").read_text())
    assert len(rep["history"]) == 2
    assert all(np.isfinite(e["train"]["loss"]) for e in rep["history"])
    out = tmp_path / "dec"
    assert asr_inference.main([
        "--exp_dir", str(exp), "--data_dir", str(dev), "--output_dir",
        str(out), "--beam_size", "2", "--max_len", "6",
        "--device", "cpu"]) == 0
    hyps = read_2column_text(out / "text")
    assert len(hyps) == 3
    assert "RTF" in (out / "score.txt").read_text()
    s2t = Speech2Text.from_exp_dir(str(exp), beam_size=2, max_len=6,
                                   ctc_weight=0.3, device="cpu")
    feats = read_2column_text(dev / "feats.scp")
    for uid in sorted(hyps):
        assert s2t.decode_batch([np.load(feats[uid])]) == [hyps[uid]]
    with pytest.raises(ValueError, match="matrices"):
        s2t.decode_batch([np.zeros(16000, np.float32)])


def test_ssl_dump_takes_hf_weights_and_one_layer_as_the_reference(tmp_path):
    """``--torch_ckpt`` (an HF Wav2Vec2Model state dict of the dump's
    geometry, randomly initialised by ``transformers``) with ``--layer 1``,
    through both packages' bin/ssl_dump on the same data dir: the same
    feats.scp keys and text, each [T, 32] matrix within 1e-5 of max |ref|
    of the reference's."""
    transformers = pytest.importorskip("transformers")
    from espnet_slurp_tpu.bin import ssl_dump as jdump
    hf = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        hidden_size=32, num_attention_heads=2, intermediate_size=64,
        num_hidden_layers=2, feat_extract_norm="group",
        do_stable_layer_norm=False, hidden_act="gelu"))
    torch.save(hf.state_dict(), tmp_path / "w2v.pt")
    _, dev_dir = make_mini_corpus(tmp_path / "c", n_train=1, n_dev=3)
    args = ["--data_dir", str(dev_dir), "--d_model", "32", "--num_blocks",
            "2", "--n_head", "2", "--d_ff", "64", "--layer", "1",
            "--torch_ckpt", str(tmp_path / "w2v.pt")]
    assert ssl_dump.main(args + ["--out_dir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    assert jdump.main(args + ["--out_dir", str(tmp_path / "ref")]) == 0
    got = read_2column_text(tmp_path / "port" / "feats.scp")
    want = read_2column_text(tmp_path / "ref" / "feats.scp")
    assert set(got) == set(want) == set(read_2column_text(
        tmp_path / "port" / "text"))
    for uid in want:
        a, b = np.load(got[uid]), np.load(want[uid])
        assert a.shape == b.shape and a.ndim == 2 and a.shape[1] == 32
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
