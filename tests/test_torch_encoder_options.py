"""The encoder options of the port against the reference, on the CPU.

espnet_slurp_tpu_torch/models/{conformer,transformer,asr_model}.py against
espnet_slurp_tpu/models/*: the interCTC taps through the shared after_norm
(with and without self-conditioning), routed MoE blocks (``moe_every``),
``input_layer: linear``, the longformer's band attention, the Transformer
encoder, stochastic depth in eval, and ASRModel's loss and stats with the
MoE aux loss and interCTC (both tap kinds). The port's encoder runs both
through the kernels' plain versions ("auto") and eagerly ("off"). fp32,
ragged lengths, compared on valid frames at tests/test_torch_encoder.py's
atol / rtol 1e-4 (fp32 sums in another order); the loss and its stats at
rtol 1e-4, each gradient as tests/test_torch_train.py holds it. The port
alone: remat's gradients equal no-remat's at dropout 0.1 under one seed
(within 1e-6 of each tensor's max |grad|: the recompute draws the same
masks, so only the order of fp32 sums could differ), and stochastic
depth's keep rate and 1 / (1 - rate) scaling, statistically.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import conformer as jconf
from espnet_slurp_tpu.models.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from espnet_slurp_tpu_torch.models import conformer as tconf
from espnet_slurp_tpu_torch.models.asr_model import build_encoder
from espnet_slurp_tpu_torch.models.transformer import TransformerEncoder
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import (t, tiny_jax_model, tiny_port_cfg, tiny_port_model,
                          waveforms)

D, H, FF, K, V = 32, 2, 64, 7, 24
TOL = 1e-4


def _np(params):
    return jax.tree.map(np.asarray, params)


def _valid(x, lens):
    x = np.asarray(x)
    m = np.arange(x.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(m[..., None], x, 0.0)


def _feats(seed=2, idim=16):
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, 61, idim).astype(np.float32)
    return feats, np.asarray([61, 40, 23], np.int32)


def _compare_encoders(jenc, port_kw, feats, flens, flashes=("auto", "off"),
                      idim=16):
    params = _np(jenc.init(jax.random.PRNGKey(2), feats, flens)["params"])
    hs_ref, ol_ref, inter_ref = jenc.apply({"params": params}, feats, flens)
    for flash in flashes:
        port = tconf.ConformerEncoder(idim, D, H, FF, flash=flash, **port_kw)
        port.load_state_dict(flax_to_torch(params))
        with torch.no_grad():
            hs, ol, inter = port(t(feats), t(flens))
        np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_ref))
        np.testing.assert_allclose(_valid(hs, ol), _valid(hs_ref, ol_ref),
                                   atol=TOL, rtol=TOL, err_msg=flash)
        assert [k for k, _ in inter] == [k for k, _ in inter_ref]
        for (k, x), (_, r) in zip(inter, inter_ref):
            if k == "moe_aux":
                np.testing.assert_allclose(float(x), float(r), atol=TOL,
                                           rtol=TOL)
            else:
                np.testing.assert_allclose(_valid(x, ol), _valid(r, ol_ref),
                                           atol=TOL, rtol=TOL,
                                           err_msg=f"{flash} tap {k}")
    return inter


@pytest.mark.parametrize("self_cond", [False, True])
def test_interctc_taps(self_cond):
    feats, flens = _feats()
    vocab = V if self_cond else 0
    jenc = jconf.ConformerEncoder(D, H, FF, 3, K, interctc_layers=(1, 2),
                                  flash="off", self_cond_vocab=vocab)
    inter = _compare_encoders(
        jenc, dict(num_blocks=3, kernel_size=K, interctc_layers=(1, 2),
                   self_cond_vocab=vocab), feats, flens)
    assert [k for k, _ in inter] == [1, 2]
    assert inter[0][1].shape[-1] == (V if self_cond else D)


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_blocks(moe_every):
    feats, flens = _feats(5)
    jenc = jconf.ConformerEncoder(D, H, FF, 2, K, flash="off",
                                  moe_experts=4, moe_every=moe_every)
    inter = _compare_encoders(
        jenc, dict(num_blocks=2, kernel_size=K, moe_experts=4,
                   moe_every=moe_every), feats, flens)
    assert [k for k, _ in inter] == ["moe_aux"]


def test_linear_input_layer():
    feats, flens = _feats(6, idim=20)
    jenc = jconf.ConformerEncoder(D, H, FF, 2, K, flash="off",
                                  input_layer="linear")
    _compare_encoders(jenc, dict(num_blocks=2, kernel_size=K,
                                 input_layer="linear"), feats, flens,
                      idim=20)


def test_longformer_band_attention():
    feats, flens = _feats(7)
    jenc = jconf.ConformerEncoder(D, H, FF, 2, K, flash="off",
                                  attention_window=3, interctc_layers=(1,))
    _compare_encoders(jenc, dict(num_blocks=2, kernel_size=K,
                                 attention_window=3, interctc_layers=(1,)),
                      feats, flens, flashes=("off",))


def test_longformer_through_build_encoder():
    """encoder: longformer builds the band-attention conformer with eager
    attention and FFNs, as the reference's build_encoder does."""
    cfg = tiny_port_cfg(encoder="longformer", attention_window=5)
    enc = build_encoder(cfg)
    assert isinstance(enc, tconf.ConformerEncoder)
    assert (enc.attention_window, enc.use_flash) == (5, False)


def test_transformer_encoder():
    feats, flens = _feats(8)
    jenc = JaxTransformerEncoder(D, H, FF, 2)
    params = _np(jenc.init(jax.random.PRNGKey(3), feats, flens)["params"])
    hs_ref, ol_ref, inter = jenc.apply({"params": params}, feats, flens)
    port = TransformerEncoder(16, D, H, FF, 2)
    port.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        hs, ol, taps = port(t(feats), t(flens))
    assert taps == [] == list(inter)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_ref))
    np.testing.assert_allclose(_valid(hs, ol), _valid(hs_ref, ol_ref),
                               atol=TOL, rtol=TOL)


def test_stochastic_depth_in_eval_is_the_plain_encoder():
    feats, flens = _feats(9)
    jenc = jconf.ConformerEncoder(D, H, FF, 2, K, flash="off",
                                  stochastic_depth_rate=0.3)
    _compare_encoders(jenc, dict(num_blocks=2, kernel_size=K,
                                 stochastic_depth_rate=0.3), feats, flens)


def test_stochastic_depth_keep_rate_and_scaling():
    """Training at rate 0.3: each block is kept with probability 0.7 (one
    draw a block for the whole batch; over the 3 blocks whose successor
    shows the choice, x 150 forwards, the kept share within 5 sigma of
    0.7), a kept block's output is the block run with every residual
    branch scaled by 1 / 0.7, and a dropped block passes its input on."""
    rate, n = 0.3, 150
    feats, flens = _feats(10)
    enc = tconf.ConformerEncoder(16, D, H, FF, 4, K, flash="off",
                                 stochastic_depth_rate=rate)
    gen = torch.Generator().manual_seed(0)
    blocks = [getattr(enc, f"block_{i}") for i in range(4)]
    last = {}
    handles = [b.register_forward_hook(
        lambda blk, args, out: last.__setitem__(blk, (args, out)))
        for b in blocks]
    kept = dropped = 0
    with torch.no_grad():
        for _ in range(n):
            enc(t(feats), t(flens), train=True, generator=gen)
            for i in range(3):
                args, out = last[blocks[i]]
                assert args[7] == pytest.approx(1.0 / (1.0 - rate))
                nxt = last[blocks[i + 1]][0][0]
                if torch.equal(nxt, args[0]):
                    dropped += 1
                else:
                    assert torch.equal(nxt, out)
                    kept += 1
        for h in handles:
            h.remove()
        args, out = last[blocks[0]]
        torch.testing.assert_close(blocks[0](*args), out)
        plain = blocks[0](*args[:7], coeff=1.0)
        assert not torch.allclose(plain, out)
    assert kept + dropped == 3 * n
    share = kept / (3 * n)
    sigma = (rate * (1 - rate) / (3 * n)) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma, share


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_remat_gradients_equal_no_remat_at_dropout(flash):
    """remat_encoder at dropout 0.1 (K2 / K3's plain versions with their
    Philox seeds on "auto", the eager masks on "off") and stochastic depth
    0.2, one seed: the loss and every gradient equal the run without
    remat; the recompute launches the blocks' forwards again."""
    cfg = tiny_port_cfg(dropout_rate=0.1, specaug=None,
                        stochastic_depth_rate=0.2, interctc_layers=(1,),
                        interctc_weight=0.3, self_conditioning=True,
                        moe_experts=4, moe_every=2, flash_attention=flash)
    x, lens = waveforms([4096, 3000], seed=12)
    text = t(np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32))
    tl = t(np.asarray([5, 3], np.int32))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        from espnet_slurp_tpu_torch.models.asr_model import ASRModel
        from espnet_slurp_tpu_torch.utils.params import init_random_
        model = init_random_(ASRModel(dataclasses.replace(
            cfg, remat_encoder=remat), device="cpu"), seed=3)
        calls = [0]
        model.encoder.block_0.register_forward_pre_hook(
            lambda *a: calls.__setitem__(0, calls[0] + 1))
        gen = torch.Generator().manual_seed(7)
        loss, _ = model(t(x), t(lens), text, tl, train=True, generator=gen)
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None}, calls[0]))
    (l0, g0, c0), (l1, g1, c1) = runs
    assert (c0, c1) == (1, 2)
    assert l1 == l0
    assert set(g0) == set(g1)
    for name in g0:
        tol = 1e-6 * max(float(g0[name].abs().max()), 1e-12)
        assert float((g0[name] - g1[name]).abs().max()) <= tol, name


# --- ASRModel: the loss and its stats -----------------------------------

LOSS_CASES = {
    "moe": dict(moe_experts=4, moe_every=2, moe_aux_weight=0.05),
    "interctc": dict(interctc_layers=(1,), interctc_weight=0.4),
    "selfcond": dict(interctc_layers=(1, 2), interctc_weight=0.4,
                     self_conditioning=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_asr_model_loss_stats_and_gradients(case):
    kw = LOSS_CASES[case]
    jmodel, params = tiny_jax_model(specaug=None, **kw)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32)
    tlens = np.asarray([5, 3], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text,
                 text_lengths=tlens)
    (ref_loss, ref_stats), ref_g = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, train=True, **batch),
        has_aux=True)(params)
    model = tiny_port_model(params, specaug=None, **kw)
    loss, stats = model(**{k: t(v) for k, v in batch.items()}, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    assert set(stats) == set(ref_stats)
    want = {"loss_moe_aux"} if "moe_experts" in kw else set()
    if "interctc_layers" in kw:
        want.add("loss_interctc")
    assert want <= set(stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=TOL, err_msg=k)
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_g))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = grads[name].grad
        tol = max(1e-4 * float(r.abs().max()), floor)
        assert float((g - r).abs().max()) <= tol, name


@pytest.mark.parametrize("case", ["selfcond"])
def test_encode_runs_the_self_conditioning_at_decode_time(case):
    """ASRModel.encode (what Speech2Text decodes from) equals the
    reference's encode, the self-conditioning residual included."""
    jmodel, params = tiny_jax_model(**LOSS_CASES[case])
    port = tiny_port_model(params, **LOSS_CASES[case])
    x, lens = waveforms([4096, 3100, 1900], seed=4)
    hs_ref, hl_ref, _ = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens),
        method=lambda m, s, sl: m.encode(s, sl))
    with torch.no_grad():
        hs, hl = port.encode(t(x), t(lens))
    np.testing.assert_allclose(_valid(hs, hl), _valid(hs_ref, hl_ref),
                               atol=TOL, rtol=TOL)


def test_a_registered_encoder_is_built_from_the_config():
    from espnet_slurp_tpu_torch.utils.registry import encoders

    class Identity(torch.nn.Module):
        def __init__(self, cfg, idim):
            super().__init__()
            self.proj = torch.nn.Linear(idim, cfg.d_model)

        def forward(self, feats, lengths, train=False, generator=None):
            return self.proj(feats), lengths, []

    name = "test_identity_encoder"
    if name not in encoders:
        encoders.register(name)(Identity)
    enc = build_encoder(tiny_port_cfg(encoder=name))
    assert isinstance(enc, Identity) and enc.proj.in_features == 16
    with pytest.raises(ValueError, match="unknown encoder"):
        build_encoder(tiny_port_cfg(encoder="no_such_encoder"))
