"""The port's transducer slice against the JAX package, on the CPU.

espnet_slurp_tpu_torch/models/transducer.py (prediction network, joint,
TransducerModel loss with the auxiliary CTC, greedy decode),
tasks/asr_transducer.py:Speech2TextTransducer and utils/params.py's LSTM
bridge, held to espnet_slurp_tpu/models/transducer.py on a tiny
Conformer-transducer (one block, d 32, LSTM 24, joint 40, vocab 20), fp32,
SpecAug off, dropout 0, the same seeded inputs and the flax init's weights.
Tolerances: outputs to 1e-5 (atol; one fp32 chain in another order), the
loss and its stats to rtol 1e-4, each parameter gradient to 1e-4 of its
tensor's max |ref| floored at 1e-4 of the largest gradient entry (as
tests/test_torch_train.py), greedy tokens and texts exactly. Two recorded
reference-side divergences are asserted as such: the bf16 decode carry of
PredictionNetwork.init_carry, and the transducer encoder ignoring
subsampling_factor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data.tokenizer import CharTokenizer
from espnet_slurp_tpu.data.tokenizer import TokenIDConverter as JaxConverter
from espnet_slurp_tpu.models.asr_model import ASRConfig as JaxASRConfig
from espnet_slurp_tpu.models import transducer as jtd
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JaxFrontend
from espnet_slurp_tpu_torch.ops.specaug import SpecAugConfig
from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
from espnet_slurp_tpu_torch.models.transducer import (
    PredictionNetwork, TransducerConfig, TransducerModel,
    transducer_flagship_config, transducer_greedy_decode)
from espnet_slurp_tpu_torch.tasks.asr_transducer import Speech2TextTransducer
from espnet_slurp_tpu_torch.train.optim import OptimConfig, build_optimizer
from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, tiny_port_cfg, waveforms

VOCAB = 20
TOKENS = ["<blank>", "<unk>"] + [chr(c) for c in range(ord("a"),
                                                      ord("a") + 17)] \
    + ["<sos/eos>"]
ASR = dict(vocab_size=VOCAB, d_model=32, n_head=2, d_ff=64,
           num_encoder_blocks=1, kernel_size=7, dropout_rate=0.0,
           specaug=None)
HEAD = dict(pred_dim=24, joint_dim=40, aux_ctc_weight=0.3)


def _jax_model(prediction="lstm", **asr_kw):
    cfg = jtd.TransducerConfig(
        asr=JaxASRConfig(frontend=JaxFrontend(n_fft=128, hop_length=64,
                                              n_mels=16), **{**ASR, **asr_kw}),
        prediction=prediction, **HEAD)
    return jtd.TransducerModel(cfg)


def _port_cfg(prediction="lstm", **asr_kw) -> TransducerConfig:
    return TransducerConfig(asr=tiny_port_cfg(**{**ASR, **asr_kw}),
                            prediction=prediction, **HEAD)


def _port_model(params, prediction="lstm", **asr_kw) -> TransducerModel:
    model = TransducerModel(_port_cfg(prediction, **asr_kw), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    return model


@pytest.fixture(scope="module")
def case():
    x, lens = waveforms([2400, 1700], seed=3)
    text = np.asarray([[5, 9, 9, 17, 3], [4, 2, 7, -1, -1]], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text,
                 text_lengths=np.asarray([5, 3], np.int32))
    jmodel = _jax_model()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), **batch)["params"]
    return jmodel, jax.tree.map(np.asarray, params), batch


@pytest.fixture(scope="module")
def reference(case):
    """The JAX loss, its stats and every gradient (a port state_dict)."""
    jmodel, params, batch = case
    (_, stats), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.apply({"params": p}, train=True, **b),
        has_aux=True))(params, batch)
    return ({k: float(v) for k, v in stats.items()},
            flax_to_torch(jax.tree.map(np.asarray, grads)))


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def test_lstm_bridge_loads_strictly_with_the_same_parameters(case):
    _, params, _ = case
    leaves = jax.tree_util.tree_leaves(params)
    model = _port_model(params)  # load_state_dict is strict
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in leaves)
    sd = flax_to_torch(params)
    cell = params["prediction"]["rnn_0"]["cell"]
    np.testing.assert_array_equal(  # gate order i, f, g, o; [out, in]
        sd["prediction.rnn_0.weight_ih"].numpy()[48:72], cell["ig"]["kernel"].T)
    np.testing.assert_array_equal(sd["prediction.rnn_0.bias_hh"].numpy()[72:],
                                  cell["ho"]["bias"])


@pytest.mark.parametrize("kind", ["lstm", "stateless"])
def test_prediction_and_joint_match_flax(case, kind):
    jmodel, params, batch = case
    if kind == "stateless":
        jmodel = _jax_model("stateless")
        params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(1), **batch)["params"])
    model = _port_model(params, kind)
    rng = np.random.RandomState(2)
    labels = rng.randint(0, VOCAB, size=(2, 6)).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(labels),
                       method=lambda m, y: m.prediction(y))
    with torch.no_grad():
        out = model.prediction(t(labels).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # step by step from the initial carry, as the greedy decode drives it
    carry_j = jmodel.apply({"params": params},
                           method=lambda m: m.prediction.init_carry(2))
    carry = model.prediction.init_carry(2, "cpu")
    for u in range(3):
        gj, carry_j = jmodel.apply(
            {"params": params}, jnp.asarray(labels[:, u]), carry_j,
            method=lambda m, y, c: m.prediction.step(y, c))
        with torch.no_grad():
            g, carry = model.prediction.step(t(labels[:, u]).long(), carry)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5)
    enc = rng.randn(2, 5, 32).astype(np.float32)
    pred = np.asarray(ref)
    ref_joint = jmodel.apply({"params": params}, jnp.asarray(enc),
                             jnp.asarray(pred),
                             method=lambda m, e, p: m.joint.full(e, p))
    with torch.no_grad():
        joint = model.joint.full(t(enc), t(pred))
    np.testing.assert_allclose(joint.numpy(), np.asarray(ref_joint),
                               atol=1e-5)


def test_bf16_prediction_steps_follow_the_training_path():
    """Reference fault (ROADMAP queue 3): at bf16, PredictionNetwork.
    init_carry makes the decode carry in bf16, while __call__'s nn.RNN
    starts from flax's fp32 carry. Vocab 50, P 64, 20 labels, 3 rows.

    - The reference stepped (jit) from an fp32 zero carry reproduces its
      __call__ exactly, so the carry's type is the whole of the gap;
      stepped from its own init_carry it strays (recorded: ~1.1e-3 of a
      largest output of ~0.15).
    - The port keeps c and h in fp32 both ways: its steps from init_carry
      equal its own training forward bit for bit, and are held to the
      reference's __call__ within 3e-3 abs. That margin is bf16 rounding,
      not the carry: torch and XLA evaluate the bf16 gates in other orders,
      which moves outputs by about as much as the reference's carry gap."""
    vocab, p, n_lab, b = 50, 64, 20, 3
    labels = np.random.RandomState(0).randint(
        0, vocab, size=(b, n_lab)).astype(np.int32)
    jnet = jtd.PredictionNetwork(vocab, p, 1, "lstm", dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(labels))["params"])
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(labels)),
                     np.float32)
    step = jax.jit(lambda y, c: jnet.apply(
        {"params": params}, y, c, method=lambda m, y, c: m.step(y, c)))

    def ref_steps(carry):
        out = []
        for u in range(n_lab):
            g, carry = step(jnp.asarray(labels[:, u]), carry)
            out.append(np.asarray(g, np.float32))
        return np.stack(out, 1), carry

    init = jnet.apply({"params": params}, b,
                      method=lambda m, n: m.init_carry(n))
    assert init[0][0].dtype == jnp.bfloat16
    z = jnp.zeros((b, p), jnp.float32)
    from_fp32, _ = ref_steps([(z, z)])
    np.testing.assert_array_equal(from_fp32, ref)
    from_init, _ = ref_steps(init)
    assert np.abs(from_init - ref).max() > 5e-4

    net = PredictionNetwork(vocab, p, 1, "lstm", dtype=torch.bfloat16)
    net.load_state_dict(flax_to_torch(params))
    carry = net.init_carry(b, "cpu")
    assert all(x.dtype == torch.float32 for x in carry[0])
    outs = []
    with torch.no_grad():
        for u in range(n_lab):
            g, carry = net.step(t(labels[:, u]).long(), carry)
            outs.append(g)
        full = net(t(labels).long())
    steps = torch.stack(outs, 1)
    assert torch.equal(steps, full)
    np.testing.assert_allclose(steps.float().numpy(), ref, atol=3e-3,
                               rtol=0)


def test_encoder_follows_subsampling_factor(case):
    """Reference fault (ROADMAP queue 3): TransducerModel.setup builds its
    ConformerEncoder without subsampling_factor, so a config asking for x6
    still subsamples x4. The port's transducer builds its encoder as
    ASRModel does and follows the config."""
    _, _, batch = case
    jmodel = _jax_model(subsampling_factor=6)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), **batch)["params"]
    _, ref_len, *_ = jmodel.apply(
        {"params": params}, jnp.asarray(batch["speech"]),
        jnp.asarray(batch["speech_lengths"]),
        method=lambda m, s, sl: m.encode(s, sl))
    model = TransducerModel(_port_cfg(subsampling_factor=6), device="cpu")
    assert model.encoder.embed.factor == 6
    with torch.no_grad():
        hs, hl = model.encode(t(batch["speech"]), t(batch["speech_lengths"]))
    frames = [1 + int(n) // 64 for n in batch["speech_lengths"]]  # hop 64
    want6 = [Conv2dSubsampling.out_length_static(n, 6) for n in frames]
    want4 = [Conv2dSubsampling.out_length_static(n, 4) for n in frames]
    assert want6 != want4
    assert hl.tolist() == want6 and hs.shape[1] == max(want6)
    assert np.asarray(ref_len).tolist() == want4


@pytest.mark.parametrize("fused_conv", [False, True])
def test_loss_and_every_gradient_match(case, reference, fused_conv):
    """The loss with the auxiliary CTC and every parameter gradient; with
    ``fused_conv`` the port's conv modules go through K6's plain version
    (the reference's unfused module on the JAX side)."""
    _, params, batch = case
    ref_stats, ref = reference
    model = _port_model(params, fused_conv=fused_conv)
    assert model.encoder.block_0.conv.fused == fused_conv
    loss, stats = model(**_tbatch(batch), train=True)
    assert set(stats) == set(ref_stats) == {"loss_transducer", "loss_ctc",
                                            "loss"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), ref_stats[k], rtol=1e-4,
                                   err_msg=k)
    loss.backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = grads[name].grad
        assert g is not None and g.shape == r.shape, name
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((g - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def _jax_greedy(jmodel, params, buf, lens, max_len):
    @jax.jit
    def run(params, buf, lens):
        hs, hl, _ = jmodel.apply({"params": params}, buf, lens,
                                 method=lambda m, s, sl: m.encode(s, sl))
        return jtd.transducer_greedy_decode(jmodel, params, hs, hl,
                                            max_len=max_len)
    return [np.asarray(x) for x in run(params, buf, lens)]


def test_greedy_decode_and_speech2text_match_jax(case):
    jmodel, params, _ = case
    rng = np.random.RandomState(5)
    speeches = [rng.randn(n).astype(np.float32) * 0.1
                for n in (3000, 2200, 1200)]
    s2t = Speech2TextTransducer(_port_cfg(), flax_to_torch(params), TOKENS,
                                max_len=12, device="cpu")
    buf, lens = s2t.pad_batch(speeches)
    assert buf.shape[0] == 4 and lens[-1] == 1
    ref_tokens, ref_lengths = _jax_greedy(jmodel, params, buf, lens, 12)
    with torch.no_grad():
        hs, hl = s2t.model.encode(t(buf), t(lens))
    tokens, lengths = transducer_greedy_decode(s2t.model, hs, hl, max_len=12)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_array_equal(lengths.numpy(), ref_lengths)
    assert (ref_lengths > 0).any()
    tok, conv = CharTokenizer(), JaxConverter(TOKENS)
    texts = [tok.tokens2text(conv.ids2tokens(ref_tokens[i, :ref_lengths[i]]))
             for i in range(len(speeches))]
    assert s2t.decode_batch(speeches) == texts
    one = _jax_greedy(jmodel, params, *s2t.pad_batch(speeches[1:2]), 12)
    assert s2t(speeches[1]) == tok.tokens2text(
        conv.ids2tokens(one[0][0, :one[1][0]]))


def test_unported_branches_raise(case):
    _, params, _ = case
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransducerModel(_port_cfg())
    # use_tcpgen builds the KB-aware transducer: its TCPGen (queried by
    # the prediction network, so pred_dim wide) has the reference's
    # parameters (tests/test_torch_tcpgen.py holds its loss)
    kb = TransducerModel(dataclasses.replace(_port_cfg(), use_tcpgen=True),
                         device="cpu")
    from espnet_slurp_tpu.models.tcpgen import TCPGen as JaxTCPGen
    from espnet_slurp_tpu_torch.slu.kb import build_trie
    t8 = build_trie([[1, 2], [3]], pad_nodes_multiple=8)
    trie = {k: jnp.asarray(getattr(t8, k[5:])) for k in (
        "trie_token", "trie_children_tok", "trie_children_node",
        "trie_n_children")}
    jp = JaxTCPGen(HEAD["pred_dim"], VOCAB, 2).init(
        jax.random.PRNGKey(0), jnp.ones((3, HEAD["pred_dim"])),
        method=lambda m, g: m.gen_prob(g, m(g, jnp.zeros(3, jnp.int32), trie,
                                            m.encode_tree(
                                                jnp.ones((8, g.shape[-1])),
                                                trie))[1],
                                       jnp.zeros(3, jnp.int32)))["params"]
    want = {f"tcpgen.{k}": tuple(v.shape) for k, v in flax_to_torch(
        jax.tree.map(np.asarray, jp)).items()}
    got = {k: tuple(v.shape) for k, v in kb.state_dict().items()
           if k.startswith("tcpgen.")}
    assert got == want
    with pytest.raises(ValueError, match="search"):
        Speech2TextTransducer(_port_cfg(), flax_to_torch(params), TOKENS,
                              beam_size=4, search="beam", device="cpu")
    flagship = transducer_flagship_config()
    assert (flagship.asr.vocab_size, flagship.asr.num_encoder_blocks,
            flagship.aux_ctc_weight, flagship.asr.fused_conv) == (600, 12,
                                                                  0.3, False)


def test_three_cpu_train_steps_lower_the_loss(case):
    """make_train_step drives the transducer unchanged (SpecAug on, with
    masks narrow enough for 27-38 frames, fused conv modules): losses
    finite, nothing skipped, the loss falling."""
    _, params, batch = case
    specaug = SpecAugConfig(time_warp_window=2, freq_mask_width_range=(0, 4),
                            time_mask_width_range=(0, 5))
    model = TransducerModel(_port_cfg(fused_conv=True, specaug=specaug),
                            device="cpu")
    model.load_state_dict(flax_to_torch(params))
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    losses = []
    for _ in range(3):
        state, stats = step(state, _tbatch(batch))
        assert float(stats["skipped"]) == 0.0
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("fused_conv", [False, True])
def test_train_step_at_the_recipes_dropout(case, fused_conv):
    """conf/train_transducer.yaml:15 trains at dropout 0.1, and so does
    transducer_flagship_config. One tiny train step at 0.1 (the encoder's
    K2 and K3 by their plain versions with the Philox masks): loss and
    grad norm finite, nothing skipped, the loss differs from rate 0, and
    the same generator seed repeats it."""
    _, params, batch = case
    assert transducer_flagship_config().asr.dropout_rate == 0.1
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    runs = []
    for rate, seed in ((0.1, 0), (0.1, 0), (0.0, 0)):
        model = _port_model(params, fused_conv=fused_conv, dropout_rate=rate)
        state = TrainState.create(model, tx, seed=seed)
        state, stats = make_train_step(model, tx)(state, _tbatch(batch))
        assert float(stats["skipped"]) == 0.0
        assert np.isfinite(float(stats["grad_norm"]))
        runs.append(float(stats["loss"]))
    assert np.isfinite(runs).all()
    assert runs[0] == runs[1] != runs[2]
