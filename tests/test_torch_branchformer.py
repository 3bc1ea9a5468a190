"""The E-Branchformer and the contextual-block Conformer of the port against
the reference, on the CPU.

espnet_slurp_tpu_torch/models/{branchformer,contextual_block}.py against
espnet_slurp_tpu/models/{branchformer,contextual_block}.py at D 32, 2
heads, d_ff 64 (cgMLP 128), 2 blocks, kernel 7, fp32, on features of 61
frames with ragged lengths (61, 40, 23), weights carried across by
utils/params.py. The outputs on valid frames and every parameter's
gradient of a fixed random projection of them are held at atol / rtol
1e-4, as tests/test_torch_encoder_options.py holds the Conformer's. The
E-Branchformer runs with ``flash`` "auto" (K2's and K3's plain versions,
K3 masking the key lengths and chunks itself) and "off" (eager, the
additive bias), with and without a chunk mask; its padded frames feed the
last valid ones through the merge conv, so a wrong padded row shows on the
valid ones. The contextual block's token mask has both kinds of hole
(frames before frame 0 in the first block, frames past each length), and
its blocks never call K3 (the wrapper is swapped for one that raises)
while its FFNs call K2. Then ASRModel's loss, stats and gradients with
each encoder, against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.branchformer import \
    EBranchformerEncoder as JaxEBranchformer
from espnet_slurp_tpu.models.contextual_block import \
    ContextualBlockConformerEncoder as JaxContextual
from espnet_slurp_tpu_torch.models import attention as tattn
from espnet_slurp_tpu_torch.models import conformer as tconf
from espnet_slurp_tpu_torch.models.branchformer import EBranchformerEncoder
from espnet_slurp_tpu_torch.models.contextual_block import \
    ContextualBlockConformerEncoder
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (asr_pair, assert_asr_loss_matches,
                          assert_grads_match, t, valid_rows)

D, H, FF, K, BLOCKS = 32, 2, 64, 7, 2
TOL = 1e-4


def _feats(seed=2, idim=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 61, idim).astype(np.float32),
            np.asarray([61, 40, 23], np.int32))


def _compare(jenc, port, feats, flens, seed=0):
    """Valid outputs and the gradients of sum(valid(hs) * w), w ~ N(0, 1)
    fixed, of ``port`` against ``jenc`` (whose params it loads)."""
    params = jax.tree.map(np.asarray, jax.jit(jenc.init)(
        jax.random.PRNGKey(2), feats, flens)["params"])
    port.load_state_dict(flax_to_torch(params))
    hs_ref, ol_ref, inter_ref = jax.jit(lambda p: jenc.apply(
        {"params": p}, feats, flens))(params)
    w = np.random.RandomState(seed).randn(*hs_ref.shape).astype(np.float32)
    w = valid_rows(w, ol_ref)

    def ref_loss(p):
        hs, _, _ = jenc.apply({"params": p}, feats, flens)
        return jnp.sum(hs * w)

    ref_g = jax.jit(jax.grad(ref_loss))(params)
    hs, ol, inter = port(t(feats), t(flens))
    (hs * t(w)).sum().backward()
    np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_ref))
    np.testing.assert_allclose(valid_rows(hs.detach(), ol),
                               valid_rows(hs_ref, ol_ref), atol=TOL, rtol=TOL)
    assert [k for k, _ in inter] == [k for k, _ in inter_ref]
    for (_, x), (_, r) in zip(inter, inter_ref):
        np.testing.assert_allclose(valid_rows(x.detach(), ol),
                                   valid_rows(r, ol_ref), atol=TOL, rtol=TOL)
    assert_grads_match(port.named_parameters(), ref_g, TOL)


class _Counts:
    """Counts the K2 / K3 wrapper calls the models make (their plain
    versions on the CPU); ``k3_raises`` makes any K3 call fail."""

    def __init__(self, monkeypatch, k3_raises=False):
        self.k2 = self.k3 = 0
        ffn, attn = tconf.fused_ffn, tattn.rel_flash_attention

        def k2(*a, **kw):
            self.k2 += 1
            return ffn(*a, **kw)

        def k3(*a, **kw):
            if k3_raises:
                raise AssertionError("K3 called with a key-length mask")
            self.k3 += 1
            return attn(*a, **kw)

        monkeypatch.setattr(tconf, "fused_ffn", k2)
        monkeypatch.setattr(tattn, "rel_flash_attention", k3)


@pytest.mark.parametrize("flash", ["auto", "off"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_ebranchformer_encoder(flash, chunk, monkeypatch):
    feats, flens = _feats()
    kw = dict(interctc_layers=(1,)) if chunk == 0 else dict(
        chunk_size=chunk, left_chunks=1)
    jenc = JaxEBranchformer(D, H, FF, BLOCKS, cgmlp_hidden=2 * FF,
                            kernel_size=K, **kw)
    port = EBranchformerEncoder(16, D, H, FF, BLOCKS, cgmlp_hidden=2 * FF,
                                kernel_size=K, flash=flash, **kw)
    counts = _Counts(monkeypatch)
    _compare(jenc, port, feats, flens)
    # K2 twice and K3 once a block on the kernel route, none eagerly
    want = (2 * BLOCKS, BLOCKS) if flash == "auto" else (0, 0)
    assert (counts.k2, counts.k3) == want


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_contextual_block_encoder(flash, monkeypatch):
    """block 8, hop 4, look-ahead 2 (left context 2): lengths 61 / 40 / 23
    give 14 / 9 / 4 frames in 4 blocks; the first block's two leading
    slots and each row's frames past its length are holes."""
    feats, flens = _feats(3)
    geom = dict(block_size=8, hop_size=4, look_ahead=2)
    jenc = JaxContextual(D, H, FF, BLOCKS, K, **geom)
    port = ContextualBlockConformerEncoder(16, D, H, FF, BLOCKS, K,
                                           flash=flash, **geom)
    counts = _Counts(monkeypatch, k3_raises=True)
    _compare(jenc, port, feats, flens, seed=1)
    assert counts.k2 == (2 * BLOCKS if flash == "auto" else 0)
    assert counts.k3 == 0


def test_padding_reaches_the_last_valid_frames_as_in_the_reference():
    """The reference's merge conv and cgMLP ``a`` half are not pad-masked,
    so an utterance's last valid frames depend on how much padding
    follows it (ROADMAP.md queue 3). The port keeps that: alone (T 23)
    and padded to 61 frames its outputs differ on the last valid frames,
    and each equals the reference's."""
    feats, flens = _feats(4)
    one, one_len = feats[2:, :23], flens[2:]
    jenc = JaxEBranchformer(D, H, FF, BLOCKS, cgmlp_hidden=2 * FF,
                            kernel_size=K)
    port = EBranchformerEncoder(16, D, H, FF, BLOCKS, cgmlp_hidden=2 * FF,
                                kernel_size=K)
    params = jax.tree.map(np.asarray, jax.jit(jenc.init)(
        jax.random.PRNGKey(2), feats, flens)["params"])
    port.load_state_dict(flax_to_torch(params))
    outs = []
    apply = jax.jit(lambda p, x, lens: jenc.apply({"params": p}, x, lens))
    for x, lens in ((one, one_len), (feats[2:], flens[2:])):
        ref, ol, _ = apply(params, x, lens)
        with torch.no_grad():
            hs, _, _ = port(t(x), t(lens))
        n = int(ol[0])
        np.testing.assert_allclose(hs[0, :n].numpy(), np.asarray(ref[0, :n]),
                                   atol=TOL, rtol=TOL)
        outs.append(hs[0, :n].numpy())
    assert np.abs(outs[0][-1] - outs[1][-1]).max() > 1e-3


ENCODER_CASES = {
    "ebranchformer": dict(encoder="ebranchformer", interctc_layers=(1,),
                          interctc_weight=0.3),
    "ebranchformer_chunked": dict(encoder="ebranchformer", chunk_size=2,
                                  left_chunks=1),
    "contextual_block_conformer": dict(
        encoder="contextual_block_conformer", block_size=8, hop_size=4,
        look_ahead=2),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_asr_model_loss_stats_and_gradients(case):
    jmodel, params, port = asr_pair(**ENCODER_CASES[case])
    assert_asr_loss_matches(jmodel, params, port, TOL)


@pytest.mark.parametrize("option", [
    dict(input_layer="linear"), dict(subsampling_factor=6),
    dict(moe_experts=4), dict(stochastic_depth_rate=0.1),
    dict(remat_encoder=True), dict(self_conditioning=True),
    dict(fused_conv=True)])
def test_options_the_reference_ignores_raise(option):
    """The reference's E-Branchformer is built without these options and
    ignores them; the port refuses them by name (ROADMAP.md queue 3)."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from torch_parity import tiny_port_cfg
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        ASRModel(tiny_port_cfg(encoder="ebranchformer", **option),
                 device="cpu")
    with torch.no_grad():
        ASRModel(tiny_port_cfg(encoder="ebranchformer"), device="cpu")
