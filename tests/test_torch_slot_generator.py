"""slu/generator.py against the reference's.

fp32 on the CPU on both sides, at tiny widths (3 slots, d_model 16, 2
heads, 2 blocks, values of 2 tokens), inputs from np.random.RandomState,
the reference's parameters carried across by utils/params.py:
flax_to_torch:

- build_ontology_forest and walk_forest: equal arrays;
- SlotValueDecoder: logits and hidden states within MOD_TOL of max |ref|;
- SlotGenerator.forward, TCPGen off and on: the loss and every stat
  within STAT_RTOL relative, every gradient within GRAD_TOL of the
  largest gradient entry. With TCPGen the reference takes the oracle
  pointer / gate losses on the walk's DEAD steps (``p_gen_mask > 0``,
  ROADMAP.md queue 3); the port takes them on the live ones. The test
  asserts both: the reference's loss_ptr / loss_gate / p_gen_live are the
  dead-step values, the port's the live-step ones of the same pointer
  distribution, and the port's loss and gradients equal the reference's
  forward with the live mask (the reference's __call__ replayed through
  its own submodules);
- generate(), with and without the forest: the reference's generate()
  on the same parameters, token for token (the port copies its decode
  unchanged; the reference's low entity F1, ROADMAP.md queue 3, is not
  diagnosed), and each emitted token the argmax of the teacher-forced
  per-step scores of the values it emitted;
- GPT2JointText against the reference's, and from a tiny HF checkpoint
  that the test writes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import hf_transformer as jhf
from espnet_slurp_tpu.models.tcpgen import tcpgen_final_logprobs as j_final
from espnet_slurp_tpu.slu import generator as jgen
from espnet_slurp_tpu_torch.slu import generator as pgen
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

MOD_TOL, STAT_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
CFG = dict(n_slots=3, value_vocab_size=20, d_model=16, n_head=2, d_ff=32,
           num_blocks=2, max_value_len=2)
# slot s's ontology (token ids); value (7, 4) of slot 1 below is outside
# its ontology, so its walk goes dead
ONTO = [[[3, 4], [3, 5], [6, 7]], [[6, 8], [9, 10]], [[11, 12], [13, 12]]]
B, T = 2, 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _forest():
    trie, roots = jgen.build_ontology_forest(ONTO, 8)
    arrays = {"trie_token": trie.token, "trie_children_tok": trie.children_tok,
              "trie_children_node": trie.children_node,
              "trie_n_children": trie.n_children}
    return trie, roots, arrays


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    memory = rng.randn(B, T, 16).astype(np.float32)
    mask = np.arange(T)[None] < np.asarray([T, 4])[:, None]
    present = np.asarray([[1, 1, 0], [1, 0, 1]], np.int32)
    values = np.asarray([[[3, 5], [7, 4], [11, 12]],
                         [[6, 7], [9, 10], [13, -1]]], np.int32)
    vlens = np.asarray([[2, 2, 2], [2, 2, 1]], np.int32)
    return memory, mask, present, values, vlens


def _walk(trie, roots, values):
    n, l = B * CFG["n_slots"], CFG["max_value_len"]
    vals = np.maximum(values, 0).reshape(n, l)
    ys_in = np.pad(vals, ((0, 0), (1, 0)))[:, :l]
    slot_idx = np.tile(np.arange(CFG["n_slots"]), B)
    return jgen.walk_forest(trie, roots, ys_in, slot_idx)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def ref():
    trie, roots, arrays = _forest()
    memory, mask, present, values, vlens = _batch()
    node, pmask = _walk(trie, roots, values)
    out = {}
    for tcp in (False, True):
        model = jgen.SlotGenerator(jgen.SlotGenConfig(**CFG, use_tcpgen=tcp))
        kw = dict(trie=arrays, node=node, p_gen_mask=pmask) if tcp else {}
        params = jax.jit(lambda r: model.init(
            r, memory, mask, present, values, vlens, **kw))(
            jax.random.PRNGKey(3))["params"]
        out[tcp] = (model, _np(params))
    return dict(models=out, trie=trie, roots=roots, arrays=arrays,
                node=node, pmask=pmask)


def _port(tcp, params):
    m = pgen.SlotGenerator(pgen.SlotGenConfig(**CFG, use_tcpgen=tcp))
    m.load_state_dict(flax_to_torch(params))
    return m


def test_forest_and_walk_equal_the_references():
    trie_j, roots_j = jgen.build_ontology_forest(ONTO, 8)
    trie_p, roots_p = pgen.build_ontology_forest(ONTO, 8)
    np.testing.assert_array_equal(roots_p, roots_j)
    for f in ("token", "children_tok", "children_node", "n_children",
              "word_end"):
        np.testing.assert_array_equal(getattr(trie_p, f),
                                      getattr(trie_j, f))
    assert (trie_p.dead, trie_p.n_nodes) == (trie_j.dead, trie_j.n_nodes)
    rng = np.random.RandomState(1)
    prev = rng.randint(0, 15, (12, 4)).astype(np.int32)
    prev[:6, 1:3] = [[3, 4], [6, 8], [11, 12], [3, 5], [9, 10], [13, 12]]
    prev[3, 3] = -1  # an eos resets to the slot root
    slots = rng.randint(0, 3, 12)
    slots[:6] = [0, 1, 2, 0, 1, 2]
    node_j, mask_j = jgen.walk_forest(trie_j, roots_j, prev, slots)
    node_p, mask_p = pgen.walk_forest(trie_p, roots_p, prev, slots)
    np.testing.assert_array_equal(node_p, node_j)
    np.testing.assert_array_equal(mask_p, mask_j)
    assert mask_j.any() and not mask_j.all()


def test_value_decoder_matches_the_reference(ref):
    model, params = ref["models"][False]
    memory, mask, _, values, _ = _batch(1)
    n = B * CFG["n_slots"]
    ys = np.pad(np.maximum(values, 0).reshape(n, 2), ((0, 0), (1, 0)))[:, :2]
    slot_ids = np.tile(np.arange(CFG["n_slots"]), B)
    mem = np.repeat(memory, CFG["n_slots"], 0)
    mrep = np.repeat(mask, CFG["n_slots"], 0)
    dec = jgen.SlotValueDecoder(model.cfg)
    want = dec.apply({"params": params["value_decoder"]}, ys, slot_ids,
                     mem, mrep)
    pm = _port(False, params)
    got = pm.value_decoder(_t(ys), _t(slot_ids), _t(mem), _t(mrep))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.detach().numpy() - w).max()) \
            <= MOD_TOL * float(np.abs(w).max())


def _fixed_forward(m, memory, mask, present, values, vlens, trie, node,
                   pmask):
    """The reference's SlotGenerator.__call__ with the pointer / gate
    losses on the live steps (p_gen_mask == 0): the port's semantics, in
    JAX through the reference's own submodules."""
    c = m.cfg
    b, n_slots, l = values.shape
    logits_cls, _ = m.classify(memory, mask)
    tgt_c = present.astype(jnp.float32)
    loss_cls = jnp.mean(jnp.maximum(logits_cls, 0) - logits_cls * tgt_c
                        + jnp.log1p(jnp.exp(-jnp.abs(logits_cls))))
    n = b * n_slots
    vals = jnp.maximum(values, 0).reshape(n, l)
    ys_in = jnp.pad(vals, ((0, 0), (1, 0)))[:, :l]
    logits, hidden = m.value_decoder(
        ys_in, jnp.tile(jnp.arange(n_slots), (b,)),
        jnp.repeat(memory, n_slots, 0), jnp.repeat(mask, n_slots, 0))
    encs = m.tcpgen.encode_tree(m.value_decoder.embed(
        jnp.maximum(trie["trie_token"], 0)), trie)
    ptr, kb = m.tcpgen(hidden, node.reshape(n, l), trie, encs)
    p_gen = m.tcpgen.gen_prob(hidden, kb, pmask.reshape(n, l))
    logp = j_final(logits, ptr, p_gen)
    tgt = values.reshape(n, l)
    valid = (tgt >= 0) & (jnp.arange(l)[None] < vlens.reshape(n)[:, None]) \
        & present.reshape(n)[:, None].astype(bool)
    nll = -jnp.take_along_axis(logp, jnp.maximum(tgt, 0)[..., None],
                               -1)[..., 0]
    denom = jnp.maximum(jnp.sum(valid), 1)
    loss_gen = jnp.sum(jnp.where(valid, nll, 0.0)) / denom
    live = ((pmask.reshape(n, l) == 0) & valid).astype(jnp.float32)
    nlive = jnp.maximum(live.sum(), 1.0)
    p_child = jnp.take_along_axis(ptr[..., :c.value_vocab_size],
                                  jnp.maximum(tgt, 0)[..., None], -1)[..., 0]
    loss_ptr = (-jnp.log(p_child + 1e-9) * live).sum() / nlive
    loss_gate = (-jnp.log(p_gen + 1e-6) * live).sum() / nlive
    loss = loss_cls + loss_gen + c.ptr_loss_weight * loss_ptr \
        + c.gate_loss_weight * loss_gate
    return loss, {"loss_ptr": loss_ptr, "loss_gate": loss_gate,
                  "p_gen_live": (p_gen * live).sum() / nlive}, \
        (ptr, p_gen, valid)


@pytest.mark.parametrize("tcp", [False, True], ids=["plain", "tcpgen"])
def test_forward_loss_stats_and_gradients(ref, tcp):
    model, params = ref["models"][tcp]
    memory, mask, present, values, vlens = _batch(2)
    node, pmask = ref["node"], ref["pmask"]
    kw = dict(trie=ref["arrays"], node=node, p_gen_mask=pmask) if tcp else {}
    args = (memory, mask, present, values, vlens)
    (loss_r, stats_r) = jax.jit(lambda p: model.apply({"params": p}, *args,
                                                      **kw))(params)
    if tcp:
        fixed = lambda p: model.apply(
            {"params": p}, *args, ref["arrays"], node, pmask,
            method=_fixed_forward)
        (want_loss, want_stats, (ptr, p_gen, valid)) = jax.jit(fixed)(params)
        grads_r = jax.jit(jax.grad(lambda p: fixed(p)[0]))(params)
    else:
        want_loss, want_stats = loss_r, {}
        grads_r = jax.jit(jax.grad(
            lambda p: model.apply({"params": p}, *args)[0]))(params)
    grads_r = flax_to_torch(_np(grads_r))

    pm = _port(tcp, params)
    pkw = ({k: _t(v) if k != "trie" else {a: _t(b) for a, b in v.items()}
            for k, v in kw.items()})
    mem = _t(memory).requires_grad_()
    loss, stats = pm(mem, _t(mask), _t(present), _t(values), _t(vlens),
                     **pkw)
    loss.backward()
    assert sorted(stats) == sorted(stats_r)
    for k in ("loss_slot_cls", "loss_slot_gen", "slot_acc"):
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(stats_r[k]), rtol=STAT_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=STAT_RTOL)
    if tcp:
        # the documented live-mask divergence: the reference's pointer and
        # gate terms are those of the dead steps of the same distribution
        ptr, p_gen, valid = (np.asarray(x) for x in (ptr, p_gen, valid))
        n, l = valid.shape
        tgt = np.maximum(values.reshape(n, l), 0)
        p_child = np.take_along_axis(ptr[..., :CFG["value_vocab_size"]],
                                     tgt[..., None], -1)[..., 0]
        for name, live in (("port", (pmask.reshape(n, l) == 0) & valid),
                           ("reference", (pmask.reshape(n, l) > 0) & valid)):
            nl = max(live.sum(), 1.0)
            expect = {"loss_ptr": (-np.log(p_child + 1e-9) * live).sum() / nl,
                      "loss_gate": (-np.log(p_gen + 1e-6) * live).sum() / nl,
                      "p_gen_live": (p_gen * live).sum() / nl}
            have = stats if name == "port" else stats_r
            for k, v in expect.items():
                np.testing.assert_allclose(float(np.asarray(
                    have[k].detach() if name == "port" else have[k])), v,
                    rtol=1e-5, atol=1e-6, err_msg=(name, k))
        dead = (pmask.reshape(n, l) > 0) & valid
        assert dead.any() and ((pmask.reshape(n, l) == 0) & valid).any()
        assert float(stats_r["p_gen_live"]) == 0.0  # the gate is off there
        assert float(stats["p_gen_live"].detach()) > 0.0
        assert abs(float(stats["loss_ptr"].detach())
                   - float(stats_r["loss_ptr"])) > 1e-3
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(k for k in got if got[k] is not None) == sorted(grads_r)
    floor = GRAD_TOL * max(float(g.abs().max()) for g in grads_r.values())
    for k, want in grads_r.items():
        err = float((got[k] - want).abs().max())
        assert err <= floor, (k, err)


def _teacher_forced_argmax(pm, memory, mask, values, trie, roots,
                           arrays=None):
    """The argmax at every step of the teacher-forced scores of ``values``
    (the forest walk of the same values when a trie is given)."""
    kw = {}
    if trie is not None:
        node, pmask = _walk(trie, roots, values)
        kw = dict(trie={a: _t(b) for a, b in arrays.items()},
                  node=_t(node), p_gen_mask=_t(pmask))
    logp, _, _ = pm.value_logprobs(_t(memory), _t(mask),
                                   torch.as_tensor(values), **kw)
    return logp.argmax(-1).reshape(values.shape)


@pytest.mark.parametrize("forest", [False, True], ids=["no_forest",
                                                       "forest"])
def test_generate_follows_teacher_forced_scores(ref, forest):
    _, params = ref["models"][True]
    pm = _port(True, params)
    memory, mask, *_ = _batch(5)
    kw = {}
    if forest:
        bmask = torch.zeros(CFG["value_vocab_size"] + 1, dtype=torch.bool)
        kw = dict(trie={a: _t(b) for a, b in ref["arrays"].items()},
                  roots=_t(ref["roots"]), boundary_mask=bmask,
                  dead=ref["trie"].dead)
    slot_logits, vals = pm.generate(_t(memory), _t(mask), **kw)
    assert slot_logits.shape == (B, CFG["n_slots"])
    assert vals.shape == (B, CFG["n_slots"], CFG["max_value_len"])
    want = _teacher_forced_argmax(
        pm, memory, mask, vals.numpy().astype(np.int32),
        ref["trie"] if forest else None, ref["roots"], ref["arrays"])
    np.testing.assert_array_equal(vals.numpy(), want.numpy())
    # the classifier is the reference's
    model, _ = ref["models"][True]
    want_logits = model.apply({"params": params}, memory, mask,
                              method=lambda m, a, b: m.classify(a, b)[0])
    np.testing.assert_allclose(slot_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=MOD_TOL)


@pytest.mark.parametrize("forest", [False, True], ids=["no_forest",
                                                       "forest"])
def test_generate_equals_the_references(ref, forest):
    model, params = ref["models"][True]
    pm = _port(True, params)
    memory, mask, *_ = _batch(6)
    kw, jkw = {}, {}
    if forest:
        bmask = np.zeros(CFG["value_vocab_size"] + 1, bool)
        jkw = dict(trie=ref["arrays"], roots=ref["roots"],
                   boundary_mask=bmask, dead=ref["trie"].dead)
        kw = dict(trie={a: _t(b) for a, b in ref["arrays"].items()},
                  roots=_t(ref["roots"]), boundary_mask=_t(bmask),
                  dead=ref["trie"].dead)
    # eager: the reference's trie_step reads its arrays on the host
    want_logits, want = model.apply({"params": params}, memory, mask, **jkw,
                                    method=jgen.SlotGenerator.generate)
    slot_logits, vals = pm.generate(_t(memory), _t(mask), **kw)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want))
    np.testing.assert_allclose(slot_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=MOD_TOL)
    # the pointer changes what is emitted, or the forest case tests nothing
    if forest:
        _, plain = pm.generate(_t(memory), _t(mask))
        assert not torch.equal(plain, vals)


GPT2 = dict(vocab_size=30, n_embd=16, n_layer=2, n_head=2, n_positions=24)


def test_gpt2_joint_text_matches_the_reference_and_loads_a_checkpoint(
        tmp_path):
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 30, (2, 7)).astype(np.int32)
    lengths = np.asarray([7, 4], np.int32)
    j = jgen.GPT2JointText(30, 24, n_layer=2, n_head=2, n_embd=16)
    params = _np(j.init(jax.random.PRNGKey(2), tokens, lengths)["params"])
    want, want_mask = j.apply({"params": params}, tokens, lengths)
    p = pgen.GPT2JointText(30, 24, n_layer=2, n_head=2, n_embd=16)
    p.load_state_dict(flax_to_torch(params))
    got, mask = p(_t(tokens), _t(lengths))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)

    # a tiny HF checkpoint written here: config.json + pytorch_model.bin
    # with HF's key names (Conv1D weights [in, out])
    gen = torch.Generator().manual_seed(0)
    d, hf = GPT2["n_embd"], {}
    rand = lambda *s: torch.randn(*s, generator=gen) * 0.2
    hf["wte.weight"], hf["wpe.weight"] = rand(30, d), rand(24, d)
    hf["ln_f.weight"], hf["ln_f.bias"] = 1 + rand(d), rand(d)
    for i in range(2):
        for ln in ("ln_1", "ln_2"):
            hf[f"h.{i}.{ln}.weight"] = 1 + rand(d)
            hf[f"h.{i}.{ln}.bias"] = rand(d)
        for name, (a, b) in (("attn.c_attn", (d, 3 * d)),
                             ("attn.c_proj", (d, d)),
                             ("mlp.c_fc", (d, 4 * d)),
                             ("mlp.c_proj", (4 * d, d))):
            hf[f"h.{i}.{name}.weight"] = rand(a, b)
            hf[f"h.{i}.{name}.bias"] = rand(b)
    (tmp_path / "config.json").write_text(json.dumps(
        {**GPT2, "layer_norm_epsilon": 1e-5}))
    torch.save(hf, tmp_path / "pytorch_model.bin")
    p2 = pgen.GPT2JointText(0, 24, hf_dir=str(tmp_path))
    p2.load_hf_weights()
    p2.proj.load_state_dict(p.proj.state_dict())
    jhf_cfg = jhf.GPT2Config(**GPT2)
    j2 = jgen.GPT2JointText(30, 24, hf_dir=str(tmp_path))
    grafted = {"gpt2": _np(jhf.gpt2_params_from_torch(
        {k: v.numpy() for k, v in hf.items()}, jhf_cfg)),
        "proj": params["proj"]}
    want2, _ = j2.apply({"params": grafted}, tokens, lengths)
    got2, _ = p2(_t(tokens), _t(lengths))
    np.testing.assert_allclose(got2.detach().numpy(), np.asarray(want2),
                               rtol=0, atol=2e-5)
    assert float(np.abs(np.asarray(want2) - np.asarray(want)).max()) > 1e-3
