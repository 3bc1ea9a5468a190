"""The pre-encoders (Sinc, linear) and the BERT post-encoder of the port
against the reference, on the CPU.

espnet_slurp_tpu_torch/models/{preencoder,postencoder}.py against
espnet_slurp_tpu/models/{preencoder,postencoder}.py, fp32, weights carried
across by utils/params.py: the mel and Bark filter banks, the Sinc
pre-encoder over 400-sample frames (both scales; outputs and gradients
at atol / rtol 1e-4, in eval, where its dropout is off), the linear
pre-encoder, the post-encoder from scratch (with a length adaptor, on
ragged lengths) and from a tiny HF BERT directory that the test writes
(config.json + pytorch_model.bin with HF's key names), its weights grafted
by the port's ASRTask.load_postencoder_weights and by the reference's;
then ASRModel's loss, stats and gradients with each value (the Sinc model
behind ``frontend.type: sliding_window``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from espnet_slurp_tpu.models import preencoder as jpre
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.models.postencoder import \
    HFTransformersPostencoder as JaxPostencoder
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JaxFrontend
from espnet_slurp_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_slurp_tpu_torch.models import preencoder as ppre
from espnet_slurp_tpu_torch.models.asr_model import ASRModel
from espnet_slurp_tpu_torch.models.postencoder import \
    HFTransformersPostencoder
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.tasks.asr import ASRTask
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (asr_pair, assert_asr_loss_matches,
                          assert_grads_match, t, tiny_port_cfg, valid_rows,
                          waveforms)

TOL = 1e-4
SLIDING = dict(type="sliding_window", n_fft=512, win_length=400,
               hop_length=160)


@pytest.mark.parametrize("bank", ["mel_bank", "bark_bank"])
def test_filter_banks(bank):
    np.testing.assert_allclose(getattr(ppre, bank)(128, 16000.0),
                               getattr(jpre, bank)(128, 16000.0), rtol=1e-12)


def _module_compare(jmod, port, x, *args):
    """Outputs and the gradients of sum(out * w) of ``port`` against the
    flax module ``jmod`` (eval), whose params it loads."""
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(3), x, *args)["params"])
    port.load_state_dict(flax_to_torch(params))
    ref = jax.jit(lambda p: jmod.apply({"params": p}, x, *args))(params)
    w = np.random.RandomState(7).randn(*np.shape(ref)).astype(np.float32)
    ref_g = jax.jit(jax.grad(lambda p: jnp.sum(
        jmod.apply({"params": p}, x, *args) * w)))(params)
    out = port(t(x), *[t(a) for a in args])
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)
    assert_grads_match(port.named_parameters(), ref_g, TOL)


@pytest.mark.parametrize("scale", ["mel", "bark"])
def test_sinc_preencoder(scale):
    x = np.random.RandomState(1).randn(2, 3, 400).astype(np.float32) * 0.1
    jmod = jpre.LightweightSincConvs(out_channels=16, scale=scale)
    port = ppre.LightweightSincConvs(16, scale=scale)
    np.testing.assert_allclose(port.sinc.f.detach().numpy(),
                               port.sinc.initial_bands().numpy())
    _module_compare(jmod, port, x)
    assert ppre.LightweightSincConvs.out_width(400) == 1


def test_linear_preencoder():
    x = np.random.RandomState(2).randn(2, 9, 16).astype(np.float32)
    _module_compare(jpre.LinearPreencoder(output_size=20),
                    ppre.LinearPreencoder(16, 20), x)


POST = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


@pytest.mark.parametrize("adaptors", [0, 1])
def test_postencoder_from_scratch(adaptors):
    rng = np.random.RandomState(3)
    hs = rng.randn(3, 11, 24).astype(np.float32)
    lens = np.asarray([11, 7, 2], np.int32)
    jmod = JaxPostencoder(24, length_adaptor_n_layers=adaptors, **POST)
    port = HFTransformersPostencoder(24, length_adaptor_n_layers=adaptors,
                                     **POST)
    params = jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(4), hs, lens)["params"])
    port.load_state_dict(flax_to_torch(params))
    ref, ref_lens = jmod.apply({"params": params}, hs, lens)
    with torch.no_grad():
        out, out_lens = port(t(hs), t(lens))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert out.shape[1] == (11 if adaptors == 0 else 6)
    np.testing.assert_allclose(valid_rows(out, out_lens),
                               valid_rows(ref, ref_lens), atol=TOL, rtol=TOL)


BERT_DIR = dict(vocab_size=30, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=48,
                max_position_embeddings=64, type_vocab_size=2)


def write_bert_dir(path, seed=0):
    """A tiny HF BERT directory: config.json and pytorch_model.bin with
    HF's key names (``bert.``-free), drawn from a seeded generator."""
    c = BERT_DIR
    h, f = c["hidden_size"], c["intermediate_size"]
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen) * 0.2
    sd = {"embeddings.word_embeddings.weight": rnd(c["vocab_size"], h),
          "embeddings.position_embeddings.weight":
              rnd(c["max_position_embeddings"], h),
          "embeddings.token_type_embeddings.weight":
              rnd(c["type_vocab_size"], h),
          "embeddings.LayerNorm.weight": 1 + rnd(h),
          "embeddings.LayerNorm.bias": rnd(h)}
    for i in range(c["num_hidden_layers"]):
        e = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (f, h),
                             "output.dense": (h, f)}.items():
            sd[f"{e}.{name}.weight"] = rnd(o, n)
            sd[f"{e}.{name}.bias"] = rnd(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{e}.{name}.weight"] = 1 + rnd(h)
            sd[f"{e}.{name}.bias"] = rnd(h)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(
        {**c, "model_type": "bert", "layer_norm_eps": 1e-12}))
    torch.save(sd, path / "pytorch_model.bin")
    return sd


def test_postencoder_from_a_checkpoint_directory(tmp_path):
    """``postencoder_hf_dir``: the geometry from config.json, the weights
    grafted by ASRTask.load_postencoder_weights byte for byte (the word
    embedding, which inputs_embeds bypasses, is not held), and the encode
    equal to the reference's with the same graft."""
    hf = tmp_path / "bert"
    sd = write_bert_dir(hf)
    kw = dict(postencoder="hf_bert", postencoder_hf_dir=str(hf),
              postencoder_length_adaptor=1)
    jmodel = JaxASRModel(dataclasses.replace(
        _flagship_cfg(tiny=True), flash_attention="off", specaug=None, **kw))
    x, lens = waveforms([4096, 3000], seed=11)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), x, lens, np.ones((2, 3), np.int32),
        np.asarray([3, 2], np.int32))["params"])
    params = JaxASRTask.load_postencoder_weights(params, jmodel.cfg)
    port = ASRModel(tiny_port_cfg(specaug=None, **kw), device="cpu")
    bert = port.postencoder.bert
    assert (bert.cfg.hidden_size, bert.cfg.num_hidden_layers,
            bert.cfg.max_position_embeddings) == (32, 2, 64)
    ASRTask.init_params(port, 0)
    ASRTask.load_postencoder_weights(port, port.cfg)
    own = port.state_dict()
    assert torch.equal(own["postencoder.bert.layer_1_ffn_out.weight"],
                       sd["encoder.layer.1.output.dense.weight"])
    assert torch.equal(own["postencoder.bert.position_embeddings.weight"],
                       sd["embeddings.position_embeddings.weight"])
    assert not any("word_embeddings" in k for k in own)
    ref_sd = {k: v for k, v in flax_to_torch(params).items()
              if "word_embeddings" not in k}
    for k in own:
        if k.startswith("postencoder.bert."):
            assert torch.equal(own[k], ref_sd[k].float()), k
    port.load_state_dict(ref_sd)
    hs_ref, hl_ref, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(s, sl)))(params)
    with torch.no_grad():
        hs, hl = port.encode(t(x), t(lens))
    np.testing.assert_array_equal(hl.numpy(), np.asarray(hl_ref))
    np.testing.assert_allclose(valid_rows(hs, hl), valid_rows(hs_ref, hl_ref),
                               atol=TOL, rtol=TOL)


ASR_CASES = {
    "sinc": dict(preencoder="sinc", preencoder_dim=16),
    "linear": dict(preencoder="linear", preencoder_dim=20),
    "hf_bert": dict(postencoder="hf_bert", postencoder_layers=1,
                    postencoder_hidden=32, postencoder_heads=2,
                    postencoder_ff=64, postencoder_length_adaptor=1),
}


@pytest.mark.parametrize("case", sorted(ASR_CASES))
def test_asr_model_loss_stats_and_gradients(case):
    """The Sinc model (its blocks drop at 0.1 / 0.15 whatever the config's
    rate, from the flax RNG the reference's loss is not given) is held in
    eval; the others as training forwards."""
    front = {}
    if case == "sinc":
        front = dict(jax_front=JaxFrontend(**SLIDING),
                     port_front=FrontendConfig(**SLIDING))
    jmodel, params, port = asr_pair(**front, **ASR_CASES[case])
    assert_asr_loss_matches(jmodel, params, port, TOL, train=case != "sinc")
