"""The LAS (RNN) decoder and the lightweight / dynamic conv decoders of the
port against the reference, on the CPU.

espnet_slurp_tpu_torch/models/{rnn_decoder,lightconv,transformer}.py
against espnet_slurp_tpu/models/{rnn_decoder,lightconv,transformer}.py,
fp32, weights carried across by utils/params.py: teacher-forced logits on
ragged memories (valid rows at atol / rtol 1e-4), the port's stepwise
decode (``init_cache`` / ``step``, the LAS decoder's attention weights
carried in the cache, a conv decoder's GLU ring written in place) against
its own teacher-forced logits, ASRModel's loss, stats and gradients with
each decoder, and the greedy and beam decodes (tokens, lengths and the
n-best's scores) against the reference's for the LAS decoder (also with
internal-LM subtraction) and the dynamic 2-D conv decoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.decode.beam import BeamSearchConfig as JaxBeamConfig
from espnet_slurp_tpu.decode.beam import batch_beam_search as jax_beam
from espnet_slurp_tpu.decode.greedy import \
    attention_greedy_decode as jax_greedy
from espnet_slurp_tpu.models.rnn_decoder import RNNDecoder as JaxRNNDecoder
from espnet_slurp_tpu.models.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                batch_beam_search)
from espnet_slurp_tpu_torch.decode.greedy import (attention_greedy_decode,
                                                  init_decoder_cache)
from espnet_slurp_tpu_torch.models.rnn_decoder import RNNDecoder
from espnet_slurp_tpu_torch.models.transformer import TransformerDecoder
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (asr_pair, assert_asr_loss_matches, t, valid_rows,
                          waveforms)

TOL = 1e-4
V, D, U, T_ENC = 24, 32, 6, 13
CONV = ["lightconv", "lightconv2d", "dynamicconv", "dynamicconv2d"]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ys = rng.randint(1, V - 1, size=(3, U)).astype(np.int32)
    ys_lens = np.asarray([6, 4, 2], np.int32)
    mem = rng.randn(3, T_ENC, D).astype(np.float32)
    mem_lens = np.asarray([13, 9, 5], np.int32)
    return ys, ys_lens, mem, mem_lens


def _teacher_forced(jdec, port, inputs):
    ys, ys_lens, mem, mem_lens = inputs
    params = jax.tree.map(np.asarray, jax.jit(jdec.init)(
        jax.random.PRNGKey(1), ys, ys_lens, mem, mem_lens)["params"])
    port.load_state_dict(flax_to_torch(params))
    ref = np.asarray(jax.jit(lambda p: jdec.apply(
        {"params": p}, ys, ys_lens, mem, mem_lens))(params))
    with torch.no_grad():
        out = port(t(ys), t(ys_lens), t(mem), t(mem_lens)).numpy()
    np.testing.assert_allclose(valid_rows(out, ys_lens),
                               valid_rows(ref, ys_lens), atol=TOL, rtol=TOL)
    return out


def _stepwise(port, cache, inputs):
    """The port's step loop over the teacher-forced tokens -> [B, U, V]."""
    ys, _, mem, mem_lens = inputs
    with torch.no_grad():
        mem_kv = port.precompute_memory(t(mem))
        rows = []
        for i in range(U):
            logits, cache = port.step(t(ys)[:, i].long(), i, cache, mem_kv,
                                      t(mem_lens), U)
            rows.append(logits)
    return torch.stack(rows, 1).numpy()


def test_rnn_decoder_teacher_forced_and_stepwise():
    inputs = _inputs()
    jdec = JaxRNNDecoder(V, D, units=16, num_layers=2)
    port = RNNDecoder(V, D, units=16, num_layers=2)
    full = _teacher_forced(jdec, port, inputs)
    cache = port.init_cache(3, T_ENC, t(inputs[3]))
    assert set(cache) == {"layer_0", "layer_1", "att_prev"}
    np.testing.assert_allclose(cache["att_prev"].sum(-1).numpy(), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(_stepwise(port, cache, inputs), full,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", CONV)
def test_conv_decoder_teacher_forced_and_stepwise(variant):
    inputs = _inputs(1)
    kw = dict(selfattn_type=variant, conv_wshare=4, conv_kernel=5,
              conv_usebias=variant == "lightconv")
    jdec = JaxTransformerDecoder(V, D, 2, 64, 2, **kw)
    port = TransformerDecoder(V, D, 2, 64, 2, **kw)
    full = _teacher_forced(jdec, port, inputs)
    cache = port.init_cache(3, U)
    assert cache["layer_0"]["k"].shape == (3, U + 2, D)
    step = _stepwise(port, cache, inputs)
    ys_lens = inputs[1]
    np.testing.assert_allclose(valid_rows(step, ys_lens),
                               valid_rows(full, ys_lens), atol=1e-5,
                               rtol=1e-5)


DECODER_CASES = {
    "rnn": dict(decoder="rnn", rnn_decoder_units=16, rnn_decoder_layers=1),
    "lightweight_conv": dict(decoder="lightweight_conv",
                             decoder_conv_kernel=5,
                             decoder_conv_usebias=True),
    "lightweight_conv2d": dict(decoder="lightweight_conv2d",
                               decoder_conv_kernel=5),
    "dynamic_conv": dict(decoder="dynamic_conv", decoder_conv_kernel=5),
    "dynamic_conv2d": dict(decoder="dynamic_conv2d", decoder_conv_kernel=5),
}


@pytest.mark.parametrize("case", sorted(DECODER_CASES))
def test_asr_model_loss_stats_and_gradients(case):
    jmodel, params, port = asr_pair(**DECODER_CASES[case])
    assert_asr_loss_matches(jmodel, params, port, TOL)


def _decode_pair(case):
    jmodel, params, port = asr_pair(**DECODER_CASES[case])
    x, lens = waveforms([4096, 3100, 1900, 1], seed=5)
    hs_ref, hl_ref, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(s, sl)))(params)
    with torch.no_grad():
        hs, hl = port.encode(t(x), t(lens))
    np.testing.assert_allclose(valid_rows(hs, hl), valid_rows(hs_ref, hl_ref),
                               atol=TOL, rtol=TOL)
    return jmodel, params, port, (hs_ref, hl_ref), (hs, hl)


@pytest.mark.parametrize("case", ["rnn", "dynamic_conv2d"])
def test_greedy_and_beam_match_the_reference(case):
    jmodel, params, port, (hs_ref, hl_ref), (hs, hl) = _decode_pair(case)
    ref = jax.jit(lambda p, h, l: jax_greedy(jmodel, p, h, l, 8))(
        params, hs_ref, hl_ref)
    tokens, lengths = attention_greedy_decode(port, hs, hl, 8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref[1]))
    ilm = 0.2 if case == "rnn" else 0.0
    ref = jax.jit(lambda p, h, l: jax_beam(
        jmodel, p, h, l, JaxBeamConfig(beam_size=3, pre_beam_size=8,
                                       ctc_weight=0.3, max_len=8,
                                       ilm_weight=ilm),
        return_nbest=True))(params, hs_ref, hl_ref)
    ref = [np.asarray(r) for r in ref]
    out = batch_beam_search(port, hs, hl, BeamSearchConfig(
        beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8,
        ilm_weight=ilm), return_nbest=True)
    out = [o.numpy() for o in out]
    for i in range(4):
        np.testing.assert_array_equal(out[i], ref[i])
    np.testing.assert_allclose(out[4], ref[4], rtol=TOL, atol=TOL)
    assert (ref[1] > 0).any()


def test_las_cache_starts_uniform_over_the_valid_frames():
    """init_decoder_cache hands the LAS decoder t_enc and the memory
    lengths: its first attention weights are 1 / length on each row's
    valid frames, as the reference's init_decoder_cache gives them."""
    from espnet_slurp_tpu.decode.greedy import \
        init_decoder_cache as jax_init_cache
    jmodel, _, port = asr_pair(**DECODER_CASES["rnn"])
    lens = np.asarray([7, 3], np.int32)
    cache = init_decoder_cache(port, 2, 8, 7, t(lens))
    ref = jax_init_cache(jmodel.cfg, 2, 8, t_enc=7,
                         memory_lengths=jnp.asarray(lens))
    np.testing.assert_allclose(cache["att_prev"].numpy(),
                               np.asarray(ref["att_prev"]), rtol=1e-7)
    assert set(cache) == set(ref)
