"""slu/ka2g.py and utils/params.py:ka2g_state_dict against the reference.

fp32 on the CPU on both sides at tiny widths (a 2-block Conformer 32 wide,
the slot generator 32 wide with 3 slots), the reference with eager
attention, the port through its kernels' plain versions (K3, K4 then K1);
inputs from np.random.RandomState, the reference's parameters carried
across by ka2g_state_dict:

- the reference's tree has no asr/decoder subtree (its loss never calls
  the decoder): the bridge keeps the port's decoder at its initial values
  and refuses any other gap;
- KA2GModel.forward without TCPGen: the loss and every stat within
  STAT_RTOL relative, every gradient within GRAD_TOL of the largest
  gradient entry;
- with TCPGen: every stat but the pointer / gate terms equal the
  reference's; those terms, the loss and every gradient equal the
  reference's forward with the live mask (p_gen_mask == 0: the reference's
  encoder, CTC and slot generator replayed through its own submodules,
  tests/test_torch_slot_generator.py:_fixed_forward), and differ from the
  reference's dead-step terms (the documented live-mask divergence);
- generate() with and without the forest: the reference's generate() on
  the same parameters, token for token, and with the forest values that
  follow the teacher-forced scores.
"""

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.asr_model import ASRConfig as JASR
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
from espnet_slurp_tpu.slu import generator as jgen
from espnet_slurp_tpu.slu import ka2g as jka2g
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.slu import generator as pgen
from espnet_slurp_tpu_torch.slu import ka2g as pka2g
from espnet_slurp_tpu_torch.utils.params import ka2g_state_dict
from test_torch_slot_generator import _fixed_forward
import torch_parity  # noqa: F401  (each test worker's CPU threads)

STAT_RTOL, GRAD_TOL = 1e-5, 1e-4
V = 24
TINY = dict(vocab_size=V, d_model=32, n_head=2, d_ff=64,
            num_encoder_blocks=2, num_decoder_blocks=1, decoder_d_ff=64,
            kernel_size=7, dropout_rate=0.0, ctc_weight=1.0, specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
GEN = dict(n_slots=3, value_vocab_size=V, d_model=32, n_head=2, d_ff=64,
           num_blocks=1, max_value_len=2)
ONTO = [[[3, 4], [3, 5]], [[6, 8], [9, 10]], [[11, 12], [13, 12]]]


def _cfgs(tcp):
    j = jka2g.KA2GConfig(
        asr=JASR(frontend=JFront(**FRONT), flash_attention="off", **TINY),
        gen=jgen.SlotGenConfig(**GEN, use_tcpgen=tcp), slot_factor=0.7)
    p = pka2g.KA2GConfig(
        asr=ASRConfig(frontend=FrontendConfig(**FRONT), **TINY),
        gen=pgen.SlotGenConfig(**GEN, use_tcpgen=tcp), slot_factor=0.7)
    return j, p


def _batch(tcp, seed=0):
    rng = np.random.RandomState(seed)
    b = {
        "speech": (rng.randn(2, 1600) * 0.1).astype(np.float32),
        "speech_lengths": np.asarray([1600, 1100], np.int32),
        "text": rng.randint(1, V - 1, (2, 4)).astype(np.int32),
        "text_lengths": np.asarray([4, 3], np.int32),
        "slot_present": np.asarray([[1, 0, 1], [0, 1, 1]], np.int32),
        "values": np.asarray([[[3, 5], [-1, -1], [11, 7]],
                              [[-1, -1], [9, 10], [13, 12]]], np.int32),
        "value_lengths": np.asarray([[2, 0, 2], [0, 2, 2]], np.int32),
    }
    if tcp:
        trie, roots = jgen.build_ontology_forest(ONTO, 8)
        vals = np.maximum(b["values"], 0).reshape(6, 2)
        ys_in = np.pad(vals, ((0, 0), (1, 0)))[:, :2]
        node, pmask = jgen.walk_forest(trie, roots, ys_in,
                                       np.tile(np.arange(3), 2))
        b.update(trie_token=trie.token, trie_children_tok=trie.children_tok,
                 trie_children_node=trie.children_node,
                 trie_n_children=trie.n_children,
                 node=node.reshape(2, 6), p_gen_mask=pmask.reshape(2, 6))
    return b


@pytest.fixture(scope="module")
def ref():
    out = {}
    for tcp in (False, True):
        jc, _ = _cfgs(tcp)
        model = jka2g.KA2GModel(jc)
        params = jax.jit(lambda r: model.init(r, **_batch(tcp)))(
            jax.random.PRNGKey(0))["params"]
        out[tcp] = (model, jax.tree.map(np.asarray, params))
    return out


def _port(tcp, params):
    _, pc = _cfgs(tcp)
    m = pka2g.KA2GModel(pc, device="cpu")
    init = {k: v.clone() for k, v in m.state_dict().items()}
    m.load_state_dict(ka2g_state_dict(params, m))
    return m, init


def test_the_bridge_keeps_the_unused_decoder_and_refuses_other_gaps(ref):
    _, params = ref[True]
    assert "decoder" not in params["asr"]
    assert "ctc" in params["asr"]
    m, init = _port(True, params)
    kept = [k for k in init if k.startswith("asr.decoder.")]
    assert kept
    for k in kept:
        assert torch.equal(m.state_dict()[k], init[k]), k
    broken = dict(params, slotgen={k: v for k, v in params["slotgen"].items()
                                   if k != "classifier"})
    with pytest.raises(ValueError, match="classifier"):
        ka2g_state_dict(broken, m)


def _fixed_ka2g(m, speech, speech_lengths, text, text_lengths,
                slot_present, values, value_lengths, trie, node, p_gen_mask):
    """The reference's KA2GModel.__call__ with the slot generator's pointer
    / gate losses on the live steps: the port's semantics."""
    hs, h_lengths, mask = m.encode(speech, speech_lengths)
    loss_ctc = m.asr._ctc_loss_mean(hs, h_lengths, text, text_lengths)
    loss_slu, stats, _ = _fixed_forward(m.slotgen, hs, mask, slot_present,
                                        values, value_lengths, trie, node,
                                        p_gen_mask)
    return (m.cfg.asr.ctc_weight * loss_ctc + m.cfg.slot_factor * loss_slu,
            stats)


def _ref_loss_and_grads(model, params, b, tcp):
    """The reference's (loss, stats) and, without TCPGen, its gradients;
    with TCPGen the live-mask replay's (loss, its pointer / gate stats,
    its gradients)."""
    loss, stats = jax.jit(lambda p: model.apply({"params": p}, **b))(params)
    stats = {k: float(v) for k, v in stats.items()}
    if not tcp:
        grads = jax.jit(jax.grad(
            lambda p: model.apply({"params": p}, **b)[0]))(params)
        return float(loss), stats, {}, grads
    trie = {k: b[k] for k in ("trie_token", "trie_children_tok",
                              "trie_children_node", "trie_n_children")}
    args = [b[k] for k in ("speech", "speech_lengths", "text", "text_lengths",
                           "slot_present", "values", "value_lengths")]
    fixed = lambda p: model.apply({"params": p}, *args, trie, b["node"],
                                  b["p_gen_mask"], method=_fixed_ka2g)
    live_loss, live_stats = jax.jit(fixed)(params)
    grads = jax.jit(jax.grad(lambda p: fixed(p)[0]))(params)
    return (float(live_loss), stats,
            {k: float(v) for k, v in live_stats.items()}, grads)


@pytest.mark.parametrize("tcp", [False, True], ids=["nokb", "tcpgen"])
def test_forward_loss_stats_and_gradients_match(ref, tcp):
    model, params = ref[tcp]
    b = _batch(tcp, seed=3)
    want, stats_r, live_r, grads_r = _ref_loss_and_grads(model, params, b,
                                                         tcp)
    pm, _ = _port(tcp, params)
    loss, stats = pm(**{k: torch.from_numpy(v) for k, v in b.items()})
    assert sorted(stats) == sorted(stats_r)
    for k, v in stats_r.items():
        if k in live_r or k == "loss":
            continue
        np.testing.assert_allclose(float(stats[k].detach()), v,
                                   rtol=STAT_RTOL, atol=1e-7, err_msg=k)
    for k, v in live_r.items():  # the live-mask divergence
        np.testing.assert_allclose(float(stats[k].detach()), v,
                                   rtol=STAT_RTOL, atol=1e-7, err_msg=k)
    if tcp:
        assert abs(live_r["loss_ptr"] - stats_r["loss_ptr"]) > 1e-3
        assert abs(want - stats_r["loss"]) > 1e-3
    np.testing.assert_allclose(float(loss.detach()), want, rtol=STAT_RTOL)
    loss.backward()
    grads_r = {k: v for k, v in ka2g_state_dict(
        jax.tree.map(np.asarray, grads_r), pm).items()
        if not k.startswith("asr.decoder.")}
    got = {k: p.grad for k, p in pm.named_parameters() if p.grad is not None}
    assert sorted(got) == sorted(grads_r)
    floor = GRAD_TOL * max(float(v.abs().max()) for v in grads_r.values())
    for k, want in grads_r.items():
        err = float((got[k] - want).abs().max())
        assert err <= floor, (k, err)


@pytest.mark.parametrize("forest", [False, True], ids=["no_forest",
                                                       "forest"])
def test_generate_equals_the_references(ref, forest):
    model, params = ref[True]
    pm, _ = _port(True, params)
    b = _batch(True, seed=6)
    kw, jkw = {}, {}
    if forest:
        trie, roots = pgen.build_ontology_forest(ONTO, 8)
        names = ("trie_token", "trie_children_tok", "trie_children_node",
                 "trie_n_children")
        bmask = np.zeros(V + 1, bool)
        jkw = dict(trie={k: b[k] for k in names}, roots=roots,
                   boundary_mask=bmask, dead=trie.dead)
        kw = dict(trie={k: torch.from_numpy(b[k]) for k in names},
                  roots=torch.from_numpy(roots),
                  boundary_mask=torch.from_numpy(bmask), dead=trie.dead)
    if forest:
        # KA2GModel.generate's two steps: its encode under jit, then the
        # slot generator's generate eager (the reference's trie_step reads
        # its arrays on the host)
        hs, _, mask = jax.jit(lambda p: model.apply(
            {"params": p}, b["speech"], b["speech_lengths"],
            method=jka2g.KA2GModel.encode))(params)
        want_logits, want = model.apply(
            {"params": params}, hs, mask, **jkw,
            method=lambda m, h, mk, **k: m.slotgen.generate(h, mk, **k))
    else:
        want_logits, want = jax.jit(lambda p: model.apply(
            {"params": p}, b["speech"], b["speech_lengths"],
            method=jka2g.KA2GModel.generate))(params)
    logits, vals = pm.generate(torch.from_numpy(b["speech"]),
                               torch.from_numpy(b["speech_lengths"]), **kw)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-5)


def test_generate_with_the_forest(ref):
    model, params = ref[True]
    pm, _ = _port(True, params)
    b = _batch(True, seed=5)
    trie, roots = pgen.build_ontology_forest(ONTO, 8)
    tr = {k: torch.from_numpy(b[k]) for k in (
        "trie_token", "trie_children_tok", "trie_children_node",
        "trie_n_children")}
    speech = torch.from_numpy(b["speech"])
    slens = torch.from_numpy(b["speech_lengths"])
    logits, vals = pm.generate(speech, slens, trie=tr,
                               roots=torch.from_numpy(roots),
                               boundary_mask=torch.zeros(V + 1, dtype=bool),
                               dead=trie.dead)
    want = jax.jit(lambda p: model.apply(
        {"params": p}, b["speech"], b["speech_lengths"],
        method=lambda m, s, sl: m.slotgen.classify(
            *m.encode(s, sl)[::2])[0]))(params)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    hs, _, mask = pm.encode(speech, slens)
    v = vals.numpy().astype(np.int32)
    node, pmask = pgen.walk_forest(
        trie, roots, np.pad(v.reshape(6, 2), ((0, 0), (1, 0)))[:, :2],
        np.tile(np.arange(3), 2))
    logp, _, _ = pm.slotgen.value_logprobs(
        hs, mask, torch.from_numpy(v), trie=tr, node=torch.from_numpy(node),
        p_gen_mask=torch.from_numpy(pmask))
    np.testing.assert_array_equal(logp.argmax(-1).reshape(v.shape).numpy(),
                                  v)
