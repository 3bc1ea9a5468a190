"""Encoder and decoder modules of the port against the flax reference.

espnet_slurp_tpu_torch/models/{conformer,transformer,asr_model}.py vs
espnet_slurp_tpu/models/*: ConformerBlock and ConformerEncoder (flax
flash="off"; the port both through the kernels' plain versions and eager),
TransformerDecoder __call__ and step, and ASRModel.encode from raw
waveforms, all with ragged lengths, compared on valid frames. fp32 on the
CPU; stacked modules use atol/rtol 1e-4 (fp32 sums in another order),
single blocks 1e-5 / 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import conformer as jconf
from espnet_slurp_tpu.models.embedding import (
    rel_positional_embedding as jax_rel_pos)
from espnet_slurp_tpu.models.transformer import (
    TransformerDecoder as JaxDecoder)
from espnet_slurp_tpu_torch.models import conformer as tconf
from espnet_slurp_tpu_torch.models.embedding import (
    Conv2dSubsampling, rel_positional_embedding)
from espnet_slurp_tpu_torch.models.transformer import TransformerDecoder
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, tiny_jax_model, tiny_port_model, waveforms

D, H, FF, K = 32, 2, 64, 7


def _np(params):
    return jax.tree.map(np.asarray, params)


def _valid(x, lens):
    x = np.asarray(x)
    m = np.arange(x.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(m[..., None], x, 0.0)


def test_rel_positional_embedding():
    np.testing.assert_allclose(rel_positional_embedding(9, 16).numpy(),
                               np.asarray(jax_rel_pos(9, 16)))


@pytest.mark.parametrize("chunk", [(0, -1), (4, 1)])
def test_conformer_block(chunk):
    cs, lc = chunk
    rng = np.random.RandomState(0)
    b, tt = 2, 19
    x = rng.randn(b, tt, D).astype(np.float32)
    lens = np.asarray([tt, 11], np.int32)
    pos = np.asarray(jax_rel_pos(tt, D))
    pad = np.arange(tt)[None, :] < lens[:, None]
    att = pad[:, None, None, :]
    if cs:
        from espnet_slurp_tpu.ops.masks import chunk_mask
        att = att & np.asarray(chunk_mask(tt, cs, lc))[None, None]
    bias = np.where(att, 0.0, -1e9).astype(np.float32)
    blk = jconf.ConformerBlock(D, H, FF, K, causal_conv=cs > 0, chunk_size=cs,
                               left_chunks=lc)
    params = _np(blk.init(jax.random.PRNGKey(1), x, pos, bias, pad,
                          lengths=lens)["params"])
    params["self_attn"]["pos_bias_u"] = rng.randn(H, D // H).astype(
        np.float32)
    ref = blk.apply({"params": params}, x, pos, bias, pad, lengths=lens)
    for use_flash in (True, False):
        port = tconf.ConformerBlock(D, H, FF, K, causal_conv=cs > 0,
                                    use_flash=use_flash, chunk_size=cs,
                                    left_chunks=lc)
        port.load_state_dict(flax_to_torch(params))
        with torch.no_grad():
            out = port(t(x), t(pos), None if use_flash else t(bias), t(pad),
                       lengths=t(lens))
        np.testing.assert_allclose(_valid(out, lens), _valid(ref, lens),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_conformer_encoder(flash):
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 61, 16).astype(np.float32)
    flens = np.asarray([61, 40, 23], np.int32)
    enc = jconf.ConformerEncoder(D, H, FF, 2, K, flash="off")
    params = _np(enc.init(jax.random.PRNGKey(2), feats, flens)["params"])
    hs_ref, ol_ref, _ = enc.apply({"params": params}, feats, flens)
    port = tconf.ConformerEncoder(16, D, H, FF, 2, K, flash=flash)
    port.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        hs, ol, taps = port(t(feats), t(flens))
    assert taps == []
    np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_ref))
    np.testing.assert_array_equal(
        ol.numpy(), Conv2dSubsampling.out_length(t(flens)).numpy())
    assert hs.shape == hs_ref.shape
    np.testing.assert_allclose(_valid(hs, ol), _valid(hs_ref, ol_ref),
                               atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def decoder_case():
    rng = np.random.RandomState(3)
    v, b, tk = 40, 2, 13
    mem = rng.randn(b, tk, D).astype(np.float32)
    mlens = np.asarray([13, 8], np.int32)
    ys = rng.randint(0, v, size=(b, 6)).astype(np.int32)
    ylens = np.asarray([6, 4], np.int32)
    dec = JaxDecoder(v, D, H, FF, num_blocks=2)
    params = _np(dec.init(jax.random.PRNGKey(3), ys, ylens, mem,
                          mlens)["params"])
    port = TransformerDecoder(v, D, H, FF, num_blocks=2)
    port.load_state_dict(flax_to_torch(params))
    return dec, params, port, mem, mlens, ys, ylens


def test_decoder_call(decoder_case):
    dec, params, port, mem, mlens, ys, ylens = decoder_case
    ref = dec.apply({"params": params}, ys, ylens, mem, mlens)
    with torch.no_grad():
        out = port(t(ys).long(), t(ylens), t(mem), t(mlens))
    np.testing.assert_allclose(_valid(out, ylens), _valid(ref, ylens),
                               atol=1e-4, rtol=1e-4)


def test_decoder_step(decoder_case):
    dec, params, port, mem, mlens, ys, _ = decoder_case
    max_len = 6
    jmem = dec.apply({"params": params}, mem,
                     method=lambda m, x: m.precompute_memory(x))
    jcache = dec.apply({"params": params}, 2, max_len,
                       method=lambda m, b, l: m.init_cache(b, l))
    with torch.no_grad():
        tmem = port.precompute_memory(t(mem))
        tcache = port.init_cache(2, max_len)
        for i in range(4):
            ref, jcache = dec.apply(
                {"params": params}, jnp.asarray(ys[:, i]), i, jcache, jmem,
                mlens, max_len,
                method=lambda m, y, s, c, mk, ml, l: m.step(y, s, c, mk, ml,
                                                             l))
            out, tcache = port.step(t(ys[:, i]).long(), i, tcache, tmem,
                                    t(mlens), max_len)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4)


def test_asr_model_encode_from_waveform():
    jmodel, params = tiny_jax_model()
    port = tiny_port_model(params)
    x, lens = waveforms([4096, 3100, 1900], seed=4)
    hs_ref, hl_ref, _ = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(s, sl))
    with torch.no_grad():
        hs, hl = port.encode(t(x), t(lens))
        lp = port.ctc_logprobs(hs)
    np.testing.assert_array_equal(hl.numpy(), np.asarray(hl_ref))
    np.testing.assert_allclose(_valid(hs, hl), _valid(hs_ref, hl_ref),
                               atol=1e-4, rtol=1e-4)
    lp_ref = jmodel.apply({"params": params}, hs_ref,
                          method=lambda m, h: m.ctc_logprobs(h))
    np.testing.assert_allclose(_valid(lp, hl), _valid(lp_ref, hl_ref),
                               atol=1e-4, rtol=1e-4)
