"""The O(1)-state incremental streaming encoder of the port
(espnet_slurp_tpu_torch/decode/incremental.py) against the reference's
(espnet_slurp_tpu/decode/incremental.py, flash "off") and against the
port's own full chunk-attention encode.

The tiny configs are the reference tests' own (2 blocks x 32, chunk 4,
left 1, kernel 7, n_fft 128, hop 64, 16 mels; the long halo at chunk 2,
left 2, kernel 15). The port's step runs the model's blocks over the
trimmed window [valid cache | new] through the kernels' plain versions;
the reference's over the full masked window, eagerly. fp32 on the CPU:
frames within 1e-5 of max |ref| of the reference's; the port's frames
against its own full encode at the reference test's rtol 2e-3 / atol 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.decode.incremental import (
    IncrementalConformerEncoder as JaxIncremental)
from espnet_slurp_tpu.models.asr_model import ASRConfig as JaxASRConfig
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JaxFrontend
from espnet_slurp_tpu_torch.decode.incremental import (
    IncrementalConformerEncoder, check_incremental)
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

TINY = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
            num_decoder_blocks=1, decoder_d_ff=64, dropout_rate=0.0,
            ctc_weight=0.3, use_mvn="none", specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)


def _models(chunk=4, left=1, kernel=7, blocks=2, **port_kw):
    """(flax model, numpy params, port model) with the same weights."""
    kw = dict(TINY, num_encoder_blocks=blocks, kernel_size=kernel,
              chunk_size=chunk, left_chunks=left)
    jm = JaxASRModel(JaxASRConfig(**kw, flash_attention="off",
                                  frontend=JaxFrontend(**FRONT)))
    rng = np.random.RandomState(0)
    wav = (0.1 * rng.randn(1, 4000)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(wav),
                     jnp.asarray([4000]), jnp.ones((1, 3), jnp.int32),
                     jnp.asarray([3]))["params"]
    params = jax.tree.map(np.asarray, params)
    pm = ASRModel(ASRConfig(**kw, frontend=FrontendConfig(**FRONT),
                            **port_kw), device="cpu")
    pm.load_state_dict(flax_to_torch(params))
    return jm, params, pm


def _feed(inc, wav, feed_size):
    outs = []
    for off in range(0, len(wav), feed_size):
        outs.append(inc.feed(wav[off:off + feed_size],
                             is_final=off + feed_size >= len(wav)))
    return outs


def _port_full(pm, wav):
    with torch.inference_mode():
        hs, hl = pm.encode(torch.from_numpy(wav[None]),
                           torch.tensor([len(wav)]))
    return hs[0, :int(hl[0])].numpy()


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("feed_size", [400, 1000, 4000])
def test_incremental_matches_the_reference(feed_size):
    jm, params, pm = _models()
    wav = (0.1 * np.random.RandomState(3).randn(5000)).astype(np.float32)
    want = np.concatenate(
        [np.asarray(x) for x in _feed(JaxIncremental(jm, params), wav,
                                      feed_size)])
    got = torch.cat(_feed(IncrementalConformerEncoder(pm), wav,
                          feed_size)).numpy()
    _close(got, want)
    np.testing.assert_allclose(got, _port_full(pm, wav), rtol=2e-3,
                               atol=2e-4)


def test_long_kernel_halo():
    """A conv kernel wider than a chunk: the halo spans several chunks."""
    jm, params, pm = _models(chunk=2, left=2, kernel=15)
    wav = (0.1 * np.random.RandomState(4).randn(4500)).astype(np.float32)
    inc = IncrementalConformerEncoder(pm)
    assert inc.cache_len == (2 + 7) * 2
    got = torch.cat([inc.feed(wav[:2000]),
                     inc.feed(wav[2000:], is_final=True)]).numpy()
    jinc = JaxIncremental(jm, params)
    want = np.concatenate([jinc.feed(wav[:2000]),
                           jinc.feed(wav[2000:], is_final=True)])
    _close(got, want)
    np.testing.assert_allclose(got, _port_full(pm, wav), rtol=2e-3,
                               atol=2e-4)


def test_reset_and_reuse():
    _, _, pm = _models()
    wav = (0.1 * np.random.RandomState(5).randn(3000)).astype(np.float32)
    inc = IncrementalConformerEncoder(pm)
    inc.feed(wav[:1500])
    inc.reset()
    assert inc.n_valid == 0
    got = torch.cat([inc.feed(wav[:1000]),
                     inc.feed(wav[1000:], is_final=True)]).numpy()
    np.testing.assert_allclose(got, _port_full(pm, wav), rtol=2e-3,
                               atol=2e-4)


def _reference_window(pm, caches, x_new, n_valid, n_new, chunk, left):
    """The reference's step over the full [C | S] window with its key-valid
    mask, through the port's eager blocks (models/conformer.py with an
    additive bias): the last S frames of the last block."""
    from espnet_slurp_tpu_torch.models.embedding import (
        rel_positional_embedding)
    from espnet_slurp_tpu_torch.ops.masks import attention_bias, chunk_mask
    c = caches[0].shape[1]
    w = c + chunk
    idx = torch.arange(w)
    key_valid = (idx >= c - n_valid) & (idx < c + n_new)
    att = chunk_mask(w, chunk, left)[None, None] & key_valid
    bias = attention_bias(att)
    pos = rel_positional_embedding(w, 32)
    x = x_new
    for i, cache in enumerate(caches):
        block = getattr(pm.encoder, f"block_{i}")
        block.self_attn.use_flash = False
        out = block(torch.cat([cache, x], 1), pos, bias, key_valid[None])
        block.self_attn.use_flash = True
        x = out[:, -chunk:]
    return pm.encoder.after_norm(x)


class _Frames(torch.nn.Module):
    """An input layer that gives fixed frames (the step scales its output
    by sqrt(D))."""

    def __init__(self, x):
        super().__init__()
        self.x = x

    def forward(self, mel):
        return self.x / np.sqrt(32)


@pytest.mark.parametrize("n_new", [4, 3])
def test_trimmed_window_step_equals_the_full_masked_window(n_new):
    """At every n_valid of a stream (0 up to C, in whole chunks) the port's
    step over [valid cache | new] (n_valid + S frames, lengths n_valid +
    n_new) gives the reference's full-window frames; with n_new < S (a
    final partial chunk) on its first n_new frames."""
    _, _, pm = _models()
    inc = IncrementalConformerEncoder(pm)
    s, c = inc.s, inc.cache_len
    assert (s, c) == (4, 12)  # halo ceil(6 / 4) = 2 chunks, left 1
    rng = np.random.RandomState(7)
    feats = [torch.from_numpy(rng.randn(1, s, 32).astype(np.float32))
             for _ in range(2)]
    for n_valid in range(0, c + 1, s):
        caches = [torch.from_numpy(rng.randn(1, c, 32).astype(np.float32))
                  for _ in range(2)]
        # the step's own caches hold only the valid frames
        inc._caches = [x[:, c - n_valid:] for x in caches]
        # the step starts at the subsampled frames: stub the frontend out
        embed = pm.encoder.embed
        pm.encoder.embed = _Frames(feats[0])
        try:
            with torch.inference_mode():
                got = inc._step(np.zeros(inc.win_samples, np.float32), n_new)
                want = _reference_window(pm, caches, feats[0], n_valid, n_new,
                                         s, 1)
        finally:
            pm.encoder.embed = embed
        _close(got[0, :n_new].numpy(), want[0, :n_new].numpy(), 1e-5)
        assert inc.n_valid == min(n_valid + s, c)


def test_after_norm_is_applied_unlike_the_reference():
    """With a trained after_norm (scale and bias away from 1 and 0) the
    port's incremental frames stay its full encode's, while the
    reference's step, which leaves after_norm out, parts from the
    reference's own full encode (ROADMAP.md queue 3)."""
    jm, params, pm = _models()
    rng = np.random.RandomState(9)
    an = params["encoder"]["after_norm"]
    an["scale"] = (1.0 + 0.5 * rng.randn(*an["scale"].shape)).astype(
        np.float32)
    an["bias"] = (0.5 * rng.randn(*an["bias"].shape)).astype(np.float32)
    pm.load_state_dict(flax_to_torch(params))
    wav = (0.1 * np.random.RandomState(3).randn(5000)).astype(np.float32)
    got = torch.cat(_feed(IncrementalConformerEncoder(pm), wav,
                          1000)).numpy()
    np.testing.assert_allclose(got, _port_full(pm, wav), rtol=2e-3,
                               atol=2e-4)
    ref_inc = np.concatenate(_feed(JaxIncremental(jm, params), wav, 1000))
    hs, hl, _ = jm.apply({"params": params}, jnp.asarray(wav[None]),
                         jnp.asarray([len(wav)]),
                         method=lambda m, s, sl: m.encode(s, sl))
    ref_full = np.asarray(hs[0, :int(hl[0])])
    assert np.abs(ref_inc - ref_full).max() > 0.1
    np.testing.assert_allclose(got, ref_full, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("bad,match", [
    (dict(chunk_size=0), "chunk_size"),
    (dict(left_chunks=-1), "left_chunks"),
    (dict(use_mvn="utterance"), "use_mvn"),
    (dict(moe_experts=2), "MoE"),
    (dict(frontend=FrontendConfig(delta_order=1)), "delta_order"),
    (dict(self_conditioning=True), "self-conditioning"),
])
def test_unstreamable_configs_raise(bad, match):
    cfg = dataclasses.replace(ASRConfig(chunk_size=4, left_chunks=1,
                                        use_mvn="none"), **bad)
    with pytest.raises(ValueError, match=match):
        check_incremental(cfg)
