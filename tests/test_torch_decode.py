"""The serving slice end to end: the port's encode + joint CTC/attention
beam search and Speech2Text against the JAX package on the tiny flagship.

Three utterances of different lengths are padded as Speech2Text pads them
(batch to a power of two with length-1 padding rows, samples to
bucket_length(longest, 4096)). Both sides run encode + batch_beam_search
(beam 3, pre-beam 8, ctc_weight 0.3, max_len 8, n-best): the best tokens and
lengths must be identical and the n-best scores agree within 1e-4 (fp32 on
the CPU; sums in another order). Then the port's Speech2Text.decode_batch
must return the text that the JAX tokens map to, for the beam search and for
greedy decoding.
"""

import jax
import numpy as np
import pytest

from espnet_slurp_tpu.data.sampler import bucket_length as jax_bucket_length
from espnet_slurp_tpu.data.tokenizer import CharTokenizer, TokenIDConverter
from espnet_slurp_tpu.decode.beam import BeamSearchConfig as JaxBeamConfig
from espnet_slurp_tpu.decode.beam import batch_beam_search as jax_beam
from espnet_slurp_tpu.decode.greedy import attention_greedy_decode as jax_greedy
from espnet_slurp_tpu_torch.data.sampler import bucket_length
from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                batch_beam_search)
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, tiny_jax_model, tiny_port_cfg, tiny_port_model

UTT_LENGTHS = [5000, 3700, 2300]
TOKENS = (["<blank>", "<unk>", "<space>"]
          + [chr(c) for c in range(ord("a"), ord("z") + 1)]
          + [str(i) for i in range(10)]
          + [chr(c) for c in range(ord("A"), ord("X") + 1)] + ["<sos/eos>"])

@pytest.fixture(scope="module")
def case():
    jmodel, params = tiny_jax_model()
    rng = np.random.RandomState(5)
    speeches = [rng.randn(n).astype(np.float32) * 0.1 for n in UTT_LENGTHS]
    s2t = Speech2Text(tiny_port_cfg(), flax_to_torch(params), TOKENS,
                      max_len=8, beam_size=3, ctc_weight=0.3, device="cpu")
    buf, lens = s2t.pad_batch(speeches)
    return jmodel, params, speeches, s2t, buf, lens

def _jax_decode(jmodel, params, buf, lens, bs_cfg=None, max_len=8):
    @jax.jit
    def run(params, buf, lens):
        hs, hl, _ = jmodel.apply({"params": params}, buf, lens,
                                 method=lambda m, s, sl: m.encode(s, sl))
        if bs_cfg is None:
            return jax_greedy(jmodel, params, hs, hl, max_len)
        return jax_beam(jmodel, params, hs, hl, bs_cfg, return_nbest=True)
    return jax.tree.map(np.asarray, run(params, buf, lens))

def _jax_texts(tokens, lengths, n):
    tok, conv = CharTokenizer(), TokenIDConverter(TOKENS)
    return [tok.tokens2text(conv.ids2tokens(tokens[i, :lengths[i]]))
            for i in range(n)]

def test_padding_rule(case):
    _, _, speeches, _, buf, lens = case
    assert buf.shape == (4, jax_bucket_length(max(UTT_LENGTHS), 4096))
    assert bucket_length(max(UTT_LENGTHS), 4096) == buf.shape[1]
    np.testing.assert_array_equal(lens, UTT_LENGTHS + [1])

def test_beam_search_matches_jax(case):
    jmodel, params, _, _, buf, lens = case
    ref = _jax_decode(jmodel, params, buf, lens, JaxBeamConfig(
        beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8))
    port = tiny_port_model(params)
    hs, hl = port.encode(t(buf), t(lens))
    out = batch_beam_search(port, hs, hl, BeamSearchConfig(
        beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8),
        return_nbest=True)
    out = [x.numpy() for x in out]
    np.testing.assert_array_equal(out[0], ref[0])  # best tokens
    np.testing.assert_array_equal(out[1], ref[1])  # best lengths
    np.testing.assert_array_equal(out[2], ref[2])  # n-best tokens
    np.testing.assert_array_equal(out[3], ref[3])  # n-best lengths
    np.testing.assert_allclose(out[4], ref[4], atol=1e-4, rtol=1e-4)
    # ended hypotheses exist, so the frozen/eos paths were exercised
    assert (out[3] < 8).any()

def test_speech2text_beam_text_matches_jax(case):
    jmodel, params, speeches, s2t, buf, lens = case
    # Speech2Text's search uses the default pre-beam (30), as the reference
    ref = _jax_decode(jmodel, params, buf, lens, JaxBeamConfig(
        beam_size=3, ctc_weight=0.3, max_len=8))
    assert s2t.decode_batch(speeches) == _jax_texts(ref[0], ref[1],
                                                    len(speeches))

def test_speech2text_greedy_text_matches_jax(case):
    jmodel, params, speeches, s2t, buf, lens = case
    ref = _jax_decode(jmodel, params, buf, lens)
    greedy = Speech2Text(tiny_port_cfg(), flax_to_torch(params), TOKENS,
                         max_len=8, device="cpu")
    texts = _jax_texts(ref[0], ref[1], len(speeches))
    assert greedy.decode_batch(speeches) == texts
    assert greedy(speeches[1]) == _jax_texts(
        *_jax_decode(jmodel, params, *greedy.pad_batch(speeches[1:2])), 1)[0]
