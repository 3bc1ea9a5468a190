"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Inputs come from np.random.RandomState(seed); weights from the JAX
module's init, converted by espnet_slurp_tpu_torch.utils.params.
"""
import jax
import numpy as np
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.utils.params import flax_to_torch


def tiny_port_cfg(**kw) -> ASRConfig:
    """The port's copy of __graft_entry__._flagship_cfg(tiny=True)."""
    base = dict(
        vocab_size=64, d_model=32, n_head=2, d_ff=64, num_encoder_blocks=2,
        num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
        dropout_rate=0.0,
        frontend=FrontendConfig(n_fft=128, hop_length=64, n_mels=16))
    return ASRConfig(**{**base, **kw})


def tiny_jax_model(**kw):
    """(flax ASRModel, numpy params) of the tiny flagship, eager attention."""
    import dataclasses
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), flash_attention="off",
                              **kw)
    model = JaxASRModel(cfg)
    batch = _example_batch(2, 2048, 5, cfg.vocab_size)
    params = model.init(
        jax.random.PRNGKey(0), batch["speech"], batch["speech_lengths"],
        batch["text"], batch["text_lengths"])["params"]
    return model, jax.tree.map(np.asarray, params)


def tiny_port_model(params, **kw) -> ASRModel:
    model = ASRModel(tiny_port_cfg(**kw), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    return model


def waveforms(lengths, seed=0):
    """Ragged float32 waveforms [B, max(lengths)] (zero-padded), lengths."""
    rng = np.random.RandomState(seed)
    n = max(lengths)
    x = np.zeros((len(lengths), n), np.float32)
    for i, m in enumerate(lengths):
        x[i, :m] = rng.randn(m).astype(np.float32) * 0.1
    return x, np.asarray(lengths, np.int32)


def t(x):
    return torch.from_numpy(np.array(x))
