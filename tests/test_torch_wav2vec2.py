"""models/wav2vec2.py against the reference's espnet_slurp_tpu/models/
wav2vec2.py at the reference tests' micro widths (TINY: convs 16, 2 blocks
x 32; attention dropout 0 so that training forwards are deterministic),
fp32 on the CPU with the reference's parameters converted by
utils/params.py: the encoder's states and layer stack at unequal lengths,
``conv_out_lengths``, the HF weight import against ``transformers``, the
ASR model with ``encoder: wav2vec2`` at a wav2vec2 width other than
d_model (the CTC head, the Transformer and LAS decoders' memory and the
post-encoder's input sized from the encoder's), ``span_mask`` at even and
odd spans, and the pretraining loss at given draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import asr_model as jasr_model
from espnet_slurp_tpu.models import wav2vec2 as jw
from espnet_slurp_tpu_torch.models import asr_model as pasr_model
from espnet_slurp_tpu_torch.models import wav2vec2 as pw
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import assert_grads_match, t

TINY = dict(
    conv_dim=(16, 16), conv_kernel=(8, 4), conv_stride=(4, 2),
    d_model=32, n_head=2, d_ff=64, num_blocks=2, pos_conv_kernel=16,
    pos_conv_groups=2, mask_prob=0.3, mask_span=3, n_negatives=8,
    quantizer_groups=2, quantizer_entries=10, vq_dim=16, final_dim=16,
    dropout_rate=0.0)
LENGTHS = [800, 600]


def batch(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.randn(n) * 0.1
    return x, np.asarray(lengths, np.int32)


@pytest.fixture(scope="module")
def encoders():
    """(flax encoder, numpy params, port encoder carrying them)."""
    jenc = jw.Wav2Vec2Encoder(jw.Wav2Vec2Config(**TINY))
    x, lens = batch()
    params = jax.tree.map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), x, lens)["params"])
    penc = pw.Wav2Vec2Encoder(pw.Wav2Vec2Config(**TINY))
    penc.load_state_dict(flax_to_torch(params))
    return jenc, params, penc


def rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def test_encoder_states_and_layer_stack_match_the_reference(encoders):
    jenc, params, penc = encoders
    x, lens = batch()
    hs, hl, _ = jenc.apply({"params": params}, x, lens)
    stack, _ = jenc.apply({"params": params}, x, lens,
                          method=lambda m, s, l: m.layer_states(s, l))
    with torch.no_grad():
        phs, phl, taps = penc(t(x), t(lens))
        pstack, _ = penc.layer_states(t(x), t(lens))
    assert taps == ()
    np.testing.assert_array_equal(phl.numpy(), np.asarray(hl))
    assert phs.shape == hs.shape and pstack.shape == stack.shape \
        == (2, 98, TINY["num_blocks"] + 1, TINY["d_model"])
    assert rel(phs, hs) <= 1e-5
    assert rel(pstack, stack) <= 1e-5
    # zeroed past the lengths, as the reference's
    assert float(phs[1, int(hl[1]):].abs().max()) == 0.0
    assert float(pstack[1, int(hl[1]):].abs().max()) == 0.0


def test_padding_reaches_the_valid_frames_as_in_the_reference(encoders):
    """The first conv's GroupNorm runs over each channel's whole padded
    length, so an utterance's valid frames change with the padding after
    it, in both packages alike (ROADMAP.md queue 3)."""
    jenc, params, penc = encoders
    x, lens = batch()
    alone = x[1:, :600]
    with torch.no_grad():
        padded = penc(t(x), t(lens))[0][1, :73].numpy()
        single = penc(t(alone), t(lens[1:]))[0][0].numpy()
    ref_single = np.asarray(jenc.apply({"params": params}, alone,
                                       lens[1:])[0][0])
    assert rel(single, ref_single) <= 1e-5
    assert np.abs(padded - single).max() > 1e-3


def test_conv_out_lengths():
    lens = pw.conv_out_lengths(torch.tensor([800, 400, 9, 3]),
                               TINY["conv_kernel"], TINY["conv_stride"])
    ref = jw.conv_out_lengths(jnp.asarray([800, 400, 9, 3]),
                              TINY["conv_kernel"], TINY["conv_stride"])
    # (800 - 8) // 4 + 1 = 199 -> (199 - 4) // 2 + 1 = 98; too short -> 0
    np.testing.assert_array_equal(lens.numpy(), [98, 48, 0, 0])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref))


def test_hf_import_matches_transformers_in_both_weight_norm_layouts(
        tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2Config(
        conv_dim=(16, 16), conv_kernel=(8, 4), conv_stride=(4, 2),
        hidden_size=32, num_attention_heads=2, intermediate_size=64,
        num_hidden_layers=2, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, feat_extract_norm="group",
        do_stable_layer_norm=False, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        hidden_act="gelu")
    torch.manual_seed(0)
    tm = transformers.Wav2Vec2Model(hf_cfg).eval()
    wav = torch.randn(2, 800)
    with torch.no_grad():
        want = tm(wav).last_hidden_state.numpy()
    sd = tm.state_dict()
    pos = "encoder.pos_conv_embed.conv."
    if pos + "weight_g" in sd:
        other = {k.replace("weight_g", "parametrizations.weight.original0")
                 .replace("weight_v", "parametrizations.weight.original1"):
                 v for k, v in sd.items()}
    else:
        other = {k.replace("parametrizations.weight.original0", "weight_g")
                 .replace("parametrizations.weight.original1", "weight_v"):
                 v for k, v in sd.items()}
    torch.save(sd, tmp_path / "w2v.pt")
    cfg = pw.Wav2Vec2Config(**TINY)
    ref = flax_to_torch(jw.wav2vec2_params_from_torch(
        sd, jw.Wav2Vec2Config(**TINY)))
    for source in (sd, other, str(tmp_path / "w2v.pt")):
        got_sd = pw.wav2vec2_params_from_torch(source, cfg)
        assert set(got_sd) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got_sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        enc = pw.Wav2Vec2Encoder(cfg)
        enc.load_state_dict(got_sd)
        with torch.no_grad():
            got = enc(wav, torch.tensor([800, 800]))[0].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 2e-4


def test_first_norm_epsilon_departs_from_transformers_on_quiet_audio(
        monkeypatch):
    """The reference normalises the first conv with flax's GroupNorm
    epsilon 1e-6, HF's Wav2Vec2Model with torch's 1e-5 (ROADMAP.md queue
    3). On unit-variance noise (the reference test's input) the two agree
    within 2e-4; on quiet audio (0.01) imported weights give other states
    than transformers' own, and with HF's epsilon the same weights agree.
    The port follows the reference."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        conv_dim=(16, 16), conv_kernel=(8, 4), conv_stride=(4, 2),
        hidden_size=32, num_attention_heads=2, intermediate_size=64,
        num_hidden_layers=2, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, feat_extract_norm="group",
        do_stable_layer_norm=False, hidden_act="gelu")).eval()
    cfg = pw.Wav2Vec2Config(**TINY)
    enc = pw.Wav2Vec2Encoder(cfg)
    enc.load_state_dict(pw.wav2vec2_params_from_torch(hf.state_dict(), cfg))
    wav = torch.from_numpy(batch([1600], seed=5)[0]) * 0.1  # 0.01 rms
    with torch.no_grad():
        want = hf(wav).last_hidden_state
        got = enc(wav, torch.tensor([1600]))[0]
        monkeypatch.setattr(pw, "GN_EPS", 1e-5)
        with_hf_eps = enc(wav, torch.tensor([1600]))[0]
    assert float((got - want).abs().max()) > 1e-2
    assert float((with_hf_eps - want).abs().max()) < 2e-4


# ---------------------------------------------------------------------------
# The ASR model with encoder: wav2vec2, its width (48) other than d_model's
# ---------------------------------------------------------------------------

W2V_48 = dict(TINY, d_model=48, num_blocks=1)
ASR = dict(vocab_size=20, encoder="wav2vec2", d_model=32, n_head=2, d_ff=64,
           num_decoder_blocks=1, decoder_d_ff=64, ctc_weight=0.3,
           dropout_rate=0.0, specaug=None, use_mvn="none")
ASR_CASES = {
    "transformer": {},
    "las": {"decoder": "rnn", "rnn_decoder_units": 16},
    "hf_bert": {"postencoder": "hf_bert", "postencoder_hidden": 32,
                "postencoder_heads": 2, "postencoder_ff": 64,
                "postencoder_layers": 1, "postencoder_length_adaptor": 1},
}
TEXT = np.asarray([[3, 7, 7, 12], [5, 1, 9, -1]], np.int32)
TEXT_LENGTHS = np.asarray([4, 3], np.int32)


@pytest.mark.parametrize("case", sorted(ASR_CASES))
def test_asr_model_loss_and_gradients_match_the_reference(case):
    kw = dict(ASR, **ASR_CASES[case])
    jcfg = jasr_model.ASRConfig(wav2vec2=jw.Wav2Vec2Config(**W2V_48), **kw)
    pcfg = pasr_model.ASRConfig(wav2vec2=pw.Wav2Vec2Config(**W2V_48), **kw)
    jmodel = jasr_model.ASRModel(jcfg)
    x, lens = batch()
    data = dict(speech=x, speech_lengths=lens, text=TEXT,
                text_lengths=TEXT_LENGTHS)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), **data)["params"])
    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, train=True, **data),
        has_aux=True))(params)
    port = pasr_model.ASRModel(pcfg, device="cpu")
    port.load_state_dict(flax_to_torch(params))
    assert port.ctc_proj.in_features == pasr_model.memory_dim(pcfg) == (
        32 if case == "hf_bert" else 48)
    loss, stats = port(**{k: t(v) for k, v in data.items()}, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert set(stats) == set(ref_stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    assert_grads_match(port.named_parameters(), ref_g, 1e-3)


def test_bf16_head_takes_the_fp32_encoder_states_cast():
    """wav2vec2 computes in its own dtype (fp32 here) and the model in
    bf16: the states reach the CTC head (K4's wrapper takes one dtype)
    and the decoder in bf16, as the reference's bf16 layers cast them."""
    cfg = pasr_model.ASRConfig(wav2vec2=pw.Wav2Vec2Config(**W2V_48),
                               **dict(ASR, dtype="bfloat16"))
    model = pasr_model.ASRModel(cfg, device="cpu")
    x, lens = batch()
    hs, _ = model.encode(t(x), t(lens))
    assert hs.dtype == torch.bfloat16 and hs.shape[-1] == 48
    loss, _ = model(t(x), t(lens), t(TEXT), t(TEXT_LENGTHS), train=True)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_options_the_wav2vec2_path_skips_raise():
    """The reference's raw-waveform encode skips the feature dump, the
    pre-encoder and the Conformer's options, and a wav2vec2 config under
    another encoder is never read: each raises by name."""
    w = pw.Wav2Vec2Config(**W2V_48)
    for extra, name in (({"preencoder": "linear"}, "preencoder"),
                        ({"interctc_layers": (1,)}, "interctc_layers"),
                        ({"input_feats": True}, "input_feats")):
        cfg = pasr_model.ASRConfig(wav2vec2=w, **dict(ASR, **extra))
        with pytest.raises(NotImplementedError, match=name):
            pasr_model.ASRModel(cfg, device="cpu")
    cfg = pasr_model.ASRConfig(wav2vec2=w, **dict(ASR, encoder="conformer"))
    with pytest.raises(NotImplementedError, match="wav2vec2"):
        pasr_model.ASRModel(cfg, device="cpu")


# ---------------------------------------------------------------------------
# Span masks and the contrastive pretraining objective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [10, 3, 4, 1])
def test_span_mask_matches_the_reference(span):
    b, t_, p = 3, 57, 0.08
    lengths = np.asarray([57, 40, 12], np.int32)
    rng = jax.random.PRNGKey(span)
    ref = np.asarray(jw.span_mask(rng, b, t_, jnp.asarray(lengths), p, span))
    starts = np.asarray(jax.random.uniform(rng, (b, t_)) < p)
    got = pw.span_mask(t(starts), t(lengths), span).numpy()
    np.testing.assert_array_equal(got, ref)
    # frame i is masked by a start in s[i - span // 2 ... i + (span - 1) //
    # 2]: a start covers (span - 1) // 2 frames before it and span // 2
    # after it (the even span 10: 4 back, 5 ahead)
    one = torch.zeros(1, 30, dtype=torch.bool)
    one[0, 15] = True
    covered = np.flatnonzero(pw.span_mask(one, torch.tensor([30]),
                                          span)[0].numpy())
    assert covered.tolist() == list(range(15 - (span - 1) // 2,
                                          15 + span // 2 + 1))


def reference_draws(cfg, lens_frames, t_, key):
    """The reference pretraining model's three draws for ``key``: span
    starts, the quantizer's uniform noise, the distractor frames."""
    m_rng, q_rng, n_rng = jax.random.split(key, 3)
    b = len(lens_frames)
    starts = jax.random.uniform(m_rng, (b, t_)) < cfg.mask_prob
    u = jax.random.uniform(
        q_rng, (b, t_, cfg.quantizer_groups, cfg.quantizer_entries),
        minval=1e-6, maxval=1.0 - 1e-6)
    masked = jw.span_mask(m_rng, b, t_, jnp.asarray(lens_frames),
                          cfg.mask_prob, cfg.mask_span)
    logits_mask = jnp.where(masked, 0.0, -1e30)
    neg = jax.random.categorical(
        n_rng, logits_mask[:, None, :], axis=-1,
        shape=(b, t_ * cfg.n_negatives)).reshape(b, t_, cfg.n_negatives)
    return [np.asarray(a) for a in (starts, u, neg)]


def test_pretraining_loss_stats_and_gradients_at_given_draws():
    jcfg = jw.Wav2Vec2Config(**TINY)
    jmodel = jw.Wav2Vec2PretrainModel(jcfg)
    x, lens = batch()
    key = jax.random.PRNGKey(1)
    params = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(2)},
        x, lens, mask_rng=key)["params"])
    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, x, lens, mask_rng=key,
                               rngs={"dropout": jax.random.PRNGKey(2)}),
        has_aux=True))(params)
    frames = np.asarray(jw.conv_out_lengths(jnp.asarray(lens),
                                            jcfg.conv_kernel,
                                            jcfg.conv_stride))
    starts, u, neg = reference_draws(jcfg, frames, 98, key)
    port = pw.Wav2Vec2PretrainModel(pw.Wav2Vec2Config(**TINY), device="cpu")
    port.load_state_dict(flax_to_torch(params))
    loss, stats = port(t(x), t(lens), train=True, starts=t(starts),
                       gumbel_u=t(u), neg_idx=t(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert set(stats) == set(ref_stats)
    for k in set(stats) - {"acc_masked"}:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # acc_masked counts the frames whose positive scores highest. A
    # distractor quantized to the positive's own code pair ties it (q is
    # y_hard + y_soft - y_soft: equal up to rounding), so the two packages
    # may break such ties apart; they agree on every other frame.
    with torch.no_grad():
        z, _, flens = port.encoder.extract(t(x), t(lens))
        q, _ = port.quantizer(z, t(u))
        masked = pw.span_mask(t(starts), flens, TINY["mask_span"])
        idx = t(neg).long()
        frames = torch.arange(q.shape[1])[None, :, None]
        idx = torch.where(idx == frames, (idx + 1) % q.shape[1], idx)
        negs = torch.stack([q[i][idx[i]] for i in range(q.shape[0])])
        ties = ((negs - q[:, :, None]).abs().amax(-1) < 1e-5).any(-1)
    n_ties = int((ties & masked).sum())
    apart = abs(stats["acc_masked"].item() - float(ref_stats["acc_masked"]))
    assert round(apart * int(masked.sum())) <= n_ties
    assert 0.0 < stats["mask_ratio"].item() < 1.0
    assert_grads_match(port.named_parameters(), ref_g, 1e-3)


def test_pretraining_draws_from_the_generator_and_learns():
    """Without given draws every one comes from the generator: the same
    seed repeats the loss, and three Adam steps on one batch lower it."""
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    model = ASRTask.init_params(pw.Wav2Vec2PretrainModel(
        pw.Wav2Vec2Config(**TINY), device="cpu"), 0)
    x, lens = batch()
    run = lambda: model(t(x), t(lens), train=True,
                        generator=torch.Generator().manual_seed(5))
    first, stats = run()
    assert first.item() == run()[0].item()
    assert 0.0 < stats["mask_ratio"].item() < 1.0
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for _ in range(3):
        opt.zero_grad()
        loss, _ = run()
        loss.backward()
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        opt.step()
    assert run()[0].item() < first.item()


def test_config_defaults_are_the_references():
    """wav2vec2-base: 7 x 512 convs, 12 x 768, 12 heads, d_ff 3072,
    positional conv 128 / 16."""
    assert dataclasses.asdict(pw.Wav2Vec2Config()) == dataclasses.asdict(
        jw.Wav2Vec2Config())
    assert pasr_model.Wav2Vec2Config is pw.Wav2Vec2Config
