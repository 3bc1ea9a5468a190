"""Port frontend ops against the JAX package on ragged lengths.

espnet_slurp_tpu_torch/ops/{stft,mel,frontend,normalize,masks}.py vs
espnet_slurp_tpu/ops/*. Everything fp32 on the CPU; tolerance atol 1e-5 /
rtol 1e-4 (pure ops; fp32 sums in another order). Log-mel values span
about [-23, 5] (the 1e-10 clamp), so the frontend checks use atol 1e-4.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from espnet_slurp_tpu.ops import frontend as jfe
from espnet_slurp_tpu.ops import masks as jmasks
from espnet_slurp_tpu.ops import mel as jmel
from espnet_slurp_tpu.ops import normalize as jnorm
from espnet_slurp_tpu_torch.ops import frontend as tfe
from espnet_slurp_tpu_torch.ops import masks as tmasks
from espnet_slurp_tpu_torch.ops import mel as tmel
from espnet_slurp_tpu_torch.ops import normalize as tnorm
from espnet_slurp_tpu_torch.ops import stft as tstft
from torch_parity import t, waveforms

# espnet_slurp_tpu.ops re-exports a function named stft over the module.
jstft = importlib.import_module("espnet_slurp_tpu.ops.stft")

LENGTHS = [3000, 2311, 1029]


def close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n_fft,win,hop", [(128, None, 64), (512, 400, 160)])
def test_stft(n_fft, win, hop):
    x, _ = waveforms(LENGTHS)
    ref = jstft.stft(jnp.asarray(x), n_fft=n_fft, win_length=win,
                     hop_length=hop)
    out = tstft.stft(t(x), n_fft=n_fft, win_length=win, hop_length=hop)
    close(out, ref, atol=1e-4)
    lens = np.asarray(LENGTHS, np.int32)
    np.testing.assert_array_equal(
        tstft.stft_out_lengths(t(lens), n_fft, hop),
        jstft.stft_out_lengths(jnp.asarray(lens), n_fft, hop))


@pytest.mark.parametrize("htk", [False, True])
def test_logmel(htk):
    rng = np.random.RandomState(1)
    power = (rng.rand(3, 20, 65).astype(np.float32) ** 4) * 10
    power[0, 0] = 0.0  # exercises the 1e-10 clamp
    lens = np.asarray([20, 13, 7], np.int32)
    np.testing.assert_allclose(tmel.mel_filterbank(8000, 128, 16, htk=htk),
                               jmel.mel_filterbank(8000, 128, 16, htk=htk))
    ref = jmel.logmel(jnp.asarray(power), jnp.asarray(lens), fs=8000,
                      n_fft=128, n_mels=16, htk=htk)
    out = tmel.logmel(t(power), t(lens), fs=8000, n_fft=128, n_mels=16,
                      htk=htk)
    close(out, ref, atol=1e-4)


def test_default_frontend_and_utterance_mvn():
    x, lens = waveforms(LENGTHS)
    jcfg = jfe.FrontendConfig(n_fft=128, hop_length=64, n_mels=16)
    tcfg = tfe.FrontendConfig(n_fft=128, hop_length=64, n_mels=16)
    jf, jl = jfe.default_frontend(jnp.asarray(x), jnp.asarray(lens), jcfg)
    tf, tl = tfe.default_frontend(t(x), t(lens), tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    close(tf, jf, atol=1e-4)
    close(tnorm.utterance_mvn(tf, tl),
          jnorm.utterance_mvn(jf, jl), atol=1e-4)
    for means, var in [(True, True), (False, True), (False, False)]:
        close(tnorm.utterance_mvn(t(np.asarray(jf)), tl, means, var),
              jnorm.utterance_mvn(jf, jl, means, var))


def test_int16_pcm_input():
    x, lens = waveforms(LENGTHS[:2])
    pcm = (x * 32767).astype(np.int16)
    cfg = tfe.FrontendConfig(n_fft=128, hop_length=64, n_mels=16)
    jf, _ = jfe.default_frontend(
        jnp.asarray(pcm), jnp.asarray(lens),
        jfe.FrontendConfig(n_fft=128, hop_length=64, n_mels=16))
    tf, _ = tfe.default_frontend(t(pcm), t(lens), cfg)
    close(tf, jf, atol=1e-4)


def test_global_mvn():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 4).astype(np.float32)
    lens = np.asarray([9, 5], np.int32)
    mean = rng.randn(4).astype(np.float32)
    inv = rng.rand(4).astype(np.float32) + 0.5
    close(tnorm.global_mvn(t(x), t(lens), t(mean), t(inv)),
          jnorm.global_mvn(jnp.asarray(x), jnp.asarray(lens), mean, inv))


@pytest.mark.parametrize("chunk,left", [(4, -1), (3, 1), (5, 0)])
def test_masks(chunk, left):
    lens = np.asarray([7, 3, 0], np.int32)
    np.testing.assert_array_equal(tmasks.length_mask(t(lens), 7),
                                  jmasks.length_mask(jnp.asarray(lens), 7))
    np.testing.assert_array_equal(tmasks.causal_mask(6), jmasks.causal_mask(6))
    np.testing.assert_array_equal(tmasks.chunk_mask(11, chunk, left),
                                  jmasks.chunk_mask(11, chunk, left))
    m = jmasks.chunk_mask(11, chunk, left)
    np.testing.assert_array_equal(
        tmasks.attention_bias(t(m)),
        jmasks.attention_bias(m))
