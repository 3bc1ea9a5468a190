"""The RNN and VGG-RNN encoders of the port against the reference, on the
CPU.

espnet_slurp_tpu_torch/models/rnn_encoders.py against
espnet_slurp_tpu/models/rnn_encoders.py, fp32, weights carried across by
utils/params.py (the reference's cells are ``OptimizedLSTMCell_{n}`` of
the RNNP scope, forward before backward, layer by layer): VGG2L at odd T
and F (its ceil pools and its (frequency, channel) flattening), flax's
``flip_sequences`` (the backward direction's in-length flip), and both
encoders at 2 bidirectional layers of 16 units, 61 frames with ragged
lengths (61, 40, 23): outputs on valid frames and every parameter's
gradient of a fixed random projection of them at atol / rtol 1e-4. Then
ASRModel's loss, stats and gradients with each encoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.recurrent import flip_sequences

from espnet_slurp_tpu.models.rnn_encoders import VGG2L as JaxVGG2L
from espnet_slurp_tpu.models.rnn_encoders import RNNEncoder as JaxRNNEncoder
from espnet_slurp_tpu.models.rnn_encoders import \
    VGGRNNEncoder as JaxVGGRNNEncoder
from espnet_slurp_tpu_torch.models.rnn_encoders import (RNNEncoder, VGG2L,
                                                        VGGRNNEncoder,
                                                        flip_within_lengths)
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (asr_pair, assert_asr_loss_matches,
                          assert_grads_match, t, valid_rows)

TOL = 1e-4
D, UNITS, LAYERS = 32, 16, 2


def test_flip_within_lengths_is_flax_flip_sequences():
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    lens = np.asarray([7, 4], np.int32)
    want = flip_sequences(jnp.asarray(x), jnp.asarray(lens), 1, False)
    got = flip_within_lengths(t(x), t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(flip_within_lengths(got, t(lens)).numpy(),
                                  x)


@pytest.mark.parametrize("t_len,f", [(21, 15), (20, 16)])
def test_vgg2l(t_len, f):
    x = np.random.RandomState(0).randn(2, t_len, f).astype(np.float32)
    jm = JaxVGG2L()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              x)["params"])
    ref = np.asarray(jm.apply({"params": params}, x))
    port = VGG2L()
    port.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out = port(t(x)).numpy()
    assert out.shape == ref.shape == (2, -(-t_len // 4),
                                      VGG2L.out_dim(f))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    lens = np.asarray([t_len, 5, 1, 8], np.int32)
    np.testing.assert_array_equal(VGG2L.out_length(t(lens)).numpy(),
                                  np.asarray(JaxVGG2L.out_length(lens)))


def _compare(jenc, port, feats, flens):
    params = jax.tree.map(np.asarray, jax.jit(jenc.init)(
        jax.random.PRNGKey(2), feats, flens)["params"])
    port.load_state_dict(flax_to_torch(params))
    hs_ref, ol_ref, _ = jax.jit(lambda p: jenc.apply(
        {"params": p}, feats, flens))(params)
    w = valid_rows(np.random.RandomState(4).randn(
        *hs_ref.shape).astype(np.float32), ol_ref)
    ref_g = jax.jit(jax.grad(lambda p: jnp.sum(
        jenc.apply({"params": p}, feats, flens)[0] * w)))(params)
    hs, ol, taps = port(t(feats), t(flens))
    (hs * t(w)).sum().backward()
    assert taps == []
    np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_ref))
    np.testing.assert_allclose(valid_rows(hs.detach(), ol),
                               valid_rows(hs_ref, ol_ref), atol=TOL, rtol=TOL)
    assert_grads_match(port.named_parameters(), ref_g, TOL)


def _feats(seed, idim=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 61, idim).astype(np.float32),
            np.asarray([61, 40, 23], np.int32))


def test_rnn_encoder():
    feats, flens = _feats(5)
    jenc = JaxRNNEncoder(D, UNITS, LAYERS, subsample=(2, 1))
    port = RNNEncoder(16, D, UNITS, LAYERS, subsample=(2, 1))
    _compare(jenc, port, feats, flens)


def test_vgg_rnn_encoder():
    feats, flens = _feats(6, idim=15)
    jenc = JaxVGGRNNEncoder(D, UNITS, LAYERS)
    port = VGGRNNEncoder(15, D, UNITS, LAYERS)
    _compare(jenc, port, feats, flens)


RNN_CASES = {
    "rnn": dict(encoder="rnn", rnn_encoder_units=UNITS,
                rnn_encoder_layers=LAYERS, rnn_encoder_subsample=(1, 2)),
    "vgg_rnn": dict(encoder="vgg_rnn", rnn_encoder_units=UNITS,
                    rnn_encoder_layers=LAYERS),
}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_asr_model_loss_stats_and_gradients(case):
    jmodel, params, port = asr_pair(**RNN_CASES[case])
    assert_asr_loss_matches(jmodel, params, port, TOL)
