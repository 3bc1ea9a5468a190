"""The frontends, delta features and feature dumps of the port against the
reference's, on the CPU.

espnet_slurp_tpu_torch/ops/frontend.py (sliding_window_frontend,
fused_frontend, delta_features / add_deltas, default_frontend's dispatch
on ``type``) against espnet_slurp_tpu/ops/frontend.py on ragged seeded
waveforms (features within 1e-5 of max |ref| on valid frames: fp32 DFT
and mel products in another order; raw frames exactly; lengths exactly);
an ASRModel on each frontend encodes as the reference's (atol / rtol
1e-4, tests/test_torch_encoder.py's); recipe/asr_pipeline.py's
stage3_dump_feats against the reference's (every matrix within 1e-5 of
its max |ref|); then the fbank recipe trains and decodes through the
port's pipeline (stages 1-15 on the dump: the task on the npy loader and
``input_feats``, Speech2Text turning waveforms into the dump's features).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.ops import frontend as jfront
from espnet_slurp_tpu.recipe import asr_pipeline as jpipe
from espnet_slurp_tpu_torch.data.fileio import read_2column_text
from espnet_slurp_tpu_torch.ops import frontend as pfront
from espnet_slurp_tpu_torch.recipe import asr_pipeline as ppipe
from espnet_slurp_tpu_torch.tasks import asr as pasr
from torch_parity import t, tiny_jax_model, tiny_port_model, waveforms

FEAT_TOL, TOL = 1e-5, 1e-4
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)


def _valid(x, lens):
    x = np.asarray(x)
    m = np.arange(x.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(m[..., None], x, 0.0)


def _rel_close(got, want, what=""):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * scale,
                               err_msg=what)


CASES = {
    "default": dict(),
    "deltas1": dict(delta_order=1),
    "deltas2_window3": dict(delta_order=2, delta_window=3),
    "sliding_window": dict(type="sliding_window"),
    "sliding_window_win96": dict(type="sliding_window", win_length=96),
    "fused": dict(type="fused", win_length=64),
    "fused_deltas": dict(type="fused", delta_order=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frontend_equals_the_references(case):
    kw = {**FRONT, **CASES[case]}
    x, lens = waveforms([4096, 3000, 1500], seed=21)
    want, wl = jfront.default_frontend(jnp.asarray(x), jnp.asarray(lens),
                                       jfront.FrontendConfig(**kw))
    cfg = pfront.FrontendConfig(**kw)
    got, gl = pfront.default_frontend(t(x), t(lens), cfg)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert got.shape == want.shape
    assert got.shape[-1] == pfront.feature_dim(cfg)
    if cfg.type == "sliding_window":  # raw frames: the same samples
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _rel_close(_valid(got, gl), _valid(want, wl), case)


def test_deltas_replicate_each_utterances_own_edge():
    """delta_features with lengths against the reference's, on a batch
    whose rows end at different frames (the frames past a row's length
    are not its edge)."""
    rng = np.random.RandomState(3)
    f = rng.randn(3, 20, 5).astype(np.float32)
    lens = np.asarray([20, 11, 1], np.int32)
    for window in (1, 2, 4):
        want = jfront.delta_features(jnp.asarray(f), window,
                                     ilens=jnp.asarray(lens))
        got = pfront.delta_features(t(f), window, ilens=t(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        want = jfront.add_deltas(jnp.asarray(f), 2, window)
        got = pfront.add_deltas(t(f), 2, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["sliding_window", "fused", "deltas2"])
def test_model_encodes_on_each_frontend(case):
    """The encoder's input layer takes the frontend's width (feature_dim)
    and the model encodes as the reference's."""
    from espnet_slurp_tpu.ops.frontend import FrontendConfig as JF
    from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig as PF
    kw = {"sliding_window": dict(type="sliding_window", win_length=64),
          "fused": dict(type="fused", win_length=64),
          "deltas2": dict(delta_order=2)}[case]
    jmodel, params = tiny_jax_model(frontend=JF(**FRONT, **kw))
    port = tiny_port_model(params, frontend=PF(**FRONT, **kw))
    x, lens = waveforms([4096, 3100, 1900], seed=4)
    hs_ref, hl_ref, _ = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(s, sl))
    with torch.no_grad():
        hs, hl = port.encode(t(x), t(lens))
    np.testing.assert_array_equal(hl.numpy(), np.asarray(hl_ref))
    np.testing.assert_allclose(_valid(hs, hl), _valid(hs_ref, hl_ref),
                               atol=TOL, rtol=TOL)


def test_stage3_dump_equals_the_references(tmp_path):
    train, _ = make_mini_corpus(tmp_path / "c", n_train=5, n_dev=1)
    jout = jpipe.stage3_dump_feats(train, tmp_path / "j",
                                   jfront.FrontendConfig(**FRONT))
    pout = ppipe.stage3_dump_feats(train, tmp_path / "p",
                                   pfront.FrontendConfig(**FRONT),
                                   device="cpu")
    jf, pf = (read_2column_text(d / "feats.scp") for d in (jout, pout))
    assert sorted(jf) == sorted(pf) and len(pf) == 5
    for name in ("wav.scp", "text"):
        assert ((jout / name).read_text() == (pout / name).read_text())
    for uid in pf:
        want, got = np.load(jf[uid]), np.load(pf[uid])
        assert got.dtype == np.float32 and got.shape == want.shape
        _rel_close(got, want, uid)


def test_fbank_recipe_trains_and_decodes_on_the_dump(tmp_path):
    """feats_type fbank through the port's pipeline, stages 1-15: the
    resolved config is the dump's (input_feats, npy, frame buckets), the
    trained Speech2Text decodes waveforms through the dump's features
    (wav_to_feats equals stage 3's matrix), and the unpacked model decodes
    as the exp dir."""
    corpus = make_mini_corpus(tmp_path / "c", n_train=6, n_dev=2)
    cfg = pasr.load_task_config(None, {
        "exp_dir": str(tmp_path / "exp"), "max_epoch": 1,
        "optim": {"scheduler": "constant", "lr": 1e-3},
        "model": dict(d_model=32, n_head=2, d_ff=64, num_encoder_blocks=1,
                      num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
                      dropout_rate=0.0, use_mvn="global", specaug=None,
                      frontend=FRONT),
        "data": dict(train_dir=str(corpus[0]), valid_dir=str(corpus[1]),
                     token_type="word", batch_type="sorted", batch_size=4)})
    res = ppipe.run_pipeline(
        cfg, ppipe.PipelineOptions(feats_type="fbank", decode_beam_size=2,
                                   decode_max_len=8),
        stage=1, stop_stage=15, device="cpu")
    assert sorted(res["stage_seconds"]) == [1, 3, 4, 5, 10, 11, 12, 13, 14,
                                            15]
    assert res["unpack_decode_match"] is True
    exp = tmp_path / "exp"
    saved = pasr.load_task_config(str(exp / "config.yaml"))
    assert (saved.model.input_feats, saved.model.input_feats_dim,
            saved.data.feats_type, saved.data.speech_bucket_multiple) == (
        True, 16, "fbank", 64)
    s2t = pasr.Speech2Text.from_exp_dir(str(exp), device="cpu")
    from espnet_slurp_tpu_torch.data.fileio import load_wav
    dump = exp / "data" / "fbank" / "dev"
    uid, path = sorted(read_2column_text(dump / "wav.scp").items())[0]
    mat = np.load(read_2column_text(dump / "feats.scp")[uid])
    np.testing.assert_array_equal(s2t.wav_to_feats(load_wav(path)[0]), mat)
    assert len(s2t.decode_batch([load_wav(path)[0]])) == 1
    hist = (exp / "reporter.json").read_text()
    assert "loss_ctc" in hist


def test_a_transducer_takes_the_frontend_type_and_deltas():
    """The reference's transducer reads its features through
    default_frontend, so the port's transducer builds on the frontend's
    width; an encoder option the reference's transducer ignores raises
    naming queue 3."""
    from espnet_slurp_tpu_torch.models.transducer import (TransducerConfig,
                                                          TransducerModel)
    from espnet_slurp_tpu_torch.tasks import asr_transducer as ptask
    from torch_parity import tiny_port_cfg
    asr = tiny_port_cfg(frontend=pfront.FrontendConfig(
        **FRONT, type="fused", win_length=64, delta_order=1))
    model = TransducerModel(TransducerConfig(asr=asr), device="cpu")
    # idim 16 x 2 + 64 = 96 -> (96 - 3) // 2 + 1 = 47 -> 23 wide.
    assert model.encoder.embed.out.weight.shape[-1] == 23
    x, lens = waveforms([4096, 2000], seed=5)
    with torch.no_grad():
        hs, _ = model.encode(t(x), t(lens))
    assert hs.shape[-1] == 32 and torch.isfinite(hs).all()
    cfg = ptask.TransducerTaskConfig(model=TransducerConfig(asr=asr))
    ptask.refuse_unported_transducer(cfg)
    for over in (dict(moe_experts=4), dict(interctc_layers=(1,)),
                 dict(stochastic_depth_rate=0.1), dict(remat_encoder=True),
                 dict(input_layer="linear"), dict(encoder="transformer"),
                 dict(self_conditioning=True), dict(encoder="ebranchformer"),
                 dict(preencoder="linear"), dict(postencoder="hf_bert"),
                 dict(decoder="rnn")):
        bad = dataclasses.replace(cfg, model=TransducerConfig(
            asr=dataclasses.replace(asr, **over)))
        with pytest.raises(NotImplementedError, match="queue 3"):
            ptask.refuse_unported_transducer(bad)
