"""TCPGen, the biased ASR loss, the biased beam search and the KB-aware
transducer against the reference, on the CPU in fp32.

- Each tree encoder (gcn, gat, sage, treelstm) inside TCPGen: encode_tree,
  forward (the pointer distribution and kb_emb), gen_prob and
  tcpgen_final_logprobs, outputs and the gradients of a seeded cotangent
  with respect to every parameter and input, within 1e-5 of each tensor's
  max |ref|.
- trie_step: equal to the reference's on random nodes and tokens (both
  boundary conventions, a per-hypothesis root), and to walk_trie over
  teacher-forced sequences.
- ASRModel with use_tcpgen on a biasing batch of TCPGenBatchAugmenter:
  loss and stats (p_gen, p_gen_bias, loss_ptr, loss_gate) at rtol 1e-4
  and every gradient within 1e-4 of its max |ref| (floored at 1e-4 of
  the largest, as tests/test_torch_train.py), with and without
  ptr_label_mask and smoothprob_scale.
- The KB-aware transducer's loss and gradients the same way, on K5's
  plain version.
- The biased batch_beam_search: tokens and lengths equal to the
  reference's, in both conventions and with force_p_gen, and with the
  selection LM's class choice (``biasing["selection"]``), also beside an
  LM in shallow fusion.
Weights come from the reference's init, converted by flax_to_torch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.decode.beam import BeamSearchConfig as JBeamConfig
from espnet_slurp_tpu.decode.beam import batch_beam_search as j_beam
from espnet_slurp_tpu.models import tcpgen as jtcp
from espnet_slurp_tpu.models.asr_model import ASRConfig as JASRConfig
from espnet_slurp_tpu.models.asr_model import ASRModel as JASRModel
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
from espnet_slurp_tpu.decode import word_lm as jwl
from espnet_slurp_tpu.slu import kb as jkb
from espnet_slurp_tpu_torch.decode import word_lm as pwl
from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                batch_beam_search)
from espnet_slurp_tpu_torch.models import tcpgen as ptcp
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.slu import kb as pkb
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, waveforms

V, D = 20, 32
TRIE_KEYS = ("trie_token", "trie_children_tok", "trie_children_node",
             "trie_n_children")
# Token ids of the biasing words (suffix convention: 3, 6, 9, 12 end a
# word).
WORDS = [[2, 3], [2, 4, 6], [5, 6], [7, 9], [8, 9], [2, 4, 3], [10, 12],
         [7, 8, 12]]
BOUNDARY = {3, 6, 9, 12}


def _trie_dict(trie, as_torch=False):
    out = {k: getattr(trie, k[5:]) for k in TRIE_KEYS}
    return {k: (torch.from_numpy(v) if as_torch else jnp.asarray(v))
            for k, v in out.items()}


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
        f"{what}: {err:.3e} of max|ref| {np.abs(ref).max():.3e}"


# --- TCPGen and its tree encoders -----------------------------------------

@pytest.mark.parametrize("encoder", ["gcn", "gat", "sage", "treelstm"])
def test_tcpgen_and_its_tree_encoder_match(encoder):
    rng = np.random.RandomState(3)
    trie = jkb.build_trie(WORDS, 16)
    n = trie.token.shape[0]
    feats = rng.randn(n, D).astype(np.float32)
    q = rng.randn(2, 5, D).astype(np.float32)
    nodes = rng.randint(0, trie.n_nodes, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) < 0.3).astype(np.int32)
    logits = rng.randn(2, 5, V).astype(np.float32)
    cot_enc = rng.randn(n, D).astype(np.float32)
    cot_lp = rng.randn(2, 5, V).astype(np.float32)
    jt = _trie_dict(trie)

    jm = jtcp.TCPGen(D, V, 2, tree_encoder=encoder)

    def jfwd(mod, feats, q, logits):
        enc = mod.encode_tree(feats, jt)
        ptr, kb = mod(q, nodes, jt, enc)
        pg = mod.gen_prob(q, kb, mask, 0.7)
        return enc, ptr, kb, pg, jtcp.tcpgen_final_logprobs(logits, ptr, pg)

    params = jm.init(jax.random.PRNGKey(1), feats, q, logits,
                     method=jfwd)["params"]
    params = jax.tree.map(np.asarray, params)

    def jloss(p, feats, q, logits):
        out = jm.apply({"params": p}, feats, q, logits, method=jfwd)
        return jnp.sum(out[0] * cot_enc) + jnp.sum(out[4] * cot_lp), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(params, feats, q, logits)

    pm = ptcp.TCPGen(D, V, 2, tree_encoder=encoder)
    pm.load_state_dict(flax_to_torch(params))
    tfeats, tq, tlogits = (t(x).requires_grad_() for x in (feats, q, logits))
    ptrie = _trie_dict(trie, as_torch=True)
    enc = pm.encode_tree(tfeats, ptrie)
    ptr, kb = pm(tq, t(nodes), ptrie, enc)
    pg = pm.gen_prob(tq, kb, t(mask), 0.7)
    lp = ptcp.tcpgen_final_logprobs(tlogits, ptr, pg)
    for name, g, r in zip(("tree_encs", "ptr_dist", "kb_emb", "p_gen",
                           "final_logprobs"), (enc, ptr, kb, pg, lp), jout):
        _close(g, r, 1e-5, f"{encoder} {name}")
    assert float(np.abs(np.asarray(jout[3])).min()) == 0.0  # masked steps
    (enc * t(cot_enc)).sum().add((lp * t(cot_lp)).sum()).backward()
    ref_p = flax_to_torch(jax.tree.map(np.asarray, jgrads[0]))
    assert set(ref_p) == {k for k, _ in pm.named_parameters()}
    for k, p in pm.named_parameters():
        _close(p.grad, ref_p[k], 1e-5, f"{encoder} d{k}")
    for name, x, r in zip(("feats", "queries", "logits"),
                          (tfeats, tq, tlogits), jgrads[1:]):
        _close(x.grad, r, 1e-5, f"{encoder} d{name}")


def test_tcpgen_parameter_names_follow_the_flax_tree():
    """Every flax leaf of each encoder maps onto a port parameter of its
    shape, and loads with no missing or unexpected key."""
    trie = _trie_dict(jkb.build_trie(WORDS, 16))
    n = trie["trie_token"].shape[0]
    for encoder in ptcp.TREE_ENCODERS:
        jm = jtcp.TCPGen(D, V, 3, tree_encoder=encoder)

        def f(mod, x):
            enc = mod.encode_tree(x, trie)
            ptr, kb = mod(x[:4], jnp.arange(4), trie, enc)
            return mod.gen_prob(x[:4], kb, jnp.zeros(4, jnp.int32))

        params = jm.init(jax.random.PRNGKey(0), jnp.ones((n, D)),
                         method=f)["params"]
        sd = flax_to_torch(jax.tree.map(np.asarray, params))
        pm = ptcp.TCPGen(D, V, 3, tree_encoder=encoder)
        res = pm.load_state_dict(sd, strict=True)
        assert not res.missing_keys and not res.unexpected_keys
        for k, v in pm.state_dict().items():
            assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="tree encoder"):
        ptcp.TCPGen(D, V, tree_encoder="gin")


# --- trie_step --------------------------------------------------------------

@pytest.mark.parametrize("prefix", [False, True])
def test_trie_step_matches_the_reference_and_the_training_walk(prefix):
    rng = np.random.RandomState(2)
    trie = jkb.build_trie(WORDS, 16)
    eos = V - 1
    bset = {2, 5, 7, 8, 10} if prefix else BOUNDARY
    bmask = np.zeros(V + 1, bool)
    bmask[list(bset)] = True
    node = rng.randint(0, trie.n_nodes, 40).astype(np.int32)
    y = rng.randint(1, V, 40).astype(np.int32)
    y[:4] = eos
    root = rng.randint(0, 3, 40).astype(np.int32)
    jt, pt = _trie_dict(trie), _trie_dict(trie, as_torch=True)
    for r in (0, root):
        ref = jtcp.trie_step(jt, jnp.asarray(node), jnp.asarray(y),
                             jnp.asarray(bmask), eos, trie.dead,
                             root=jnp.asarray(r), prefix_boundary=prefix)
        got = ptcp.trie_step(pt, t(node), t(y), torch.from_numpy(bmask), eos,
                             trie.dead, root=t(np.asarray(r)),
                             prefix_boundary=prefix)
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # teacher-forced: the decode-time walk step by step is walk_trie's
    seqs = rng.randint(1, V, (5, 12)).astype(np.int32)
    for i in range(3):
        w = [p for j in rng.permutation(len(WORDS))[:4] for p in WORDS[j]]
        seqs[i, :len(w[:12])] = w[:12]
    seqs[:, 0] = eos
    walk_node, walk_mask = pkb.walk_trie(pkb.build_trie(WORDS, 16), seqs,
                                         bset, eos, prefix_boundary=prefix)
    cur = torch.zeros(5, dtype=torch.long)
    for j in range(seqs.shape[1]):
        cur, m = ptcp.trie_step(pt, cur, t(seqs[:, j]),
                                torch.from_numpy(bmask), eos, trie.dead,
                                prefix_boundary=prefix)
        np.testing.assert_array_equal(cur.numpy(), walk_node[:, j])
        np.testing.assert_array_equal(m.numpy(), walk_mask[:, j])
    assert (walk_node > 0).any()


# --- ASRModel with TCPGen ---------------------------------------------------

ASR = dict(vocab_size=V, d_model=D, n_head=2, d_ff=64, num_encoder_blocks=1,
           num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
           dropout_rate=0.0, use_tcpgen=True, tcpgen_ptr_loss_weight=1.0,
           tcpgen_gate_loss_weight=0.2, specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)


def _configs(**kw):
    args = {**ASR, **kw}
    return (ASRConfig(frontend=FrontendConfig(**FRONT), **args),
            JASRConfig(frontend=JFront(**FRONT), flash_attention="off",
                       **args))


def _augmented_batch(text, epoch=2, prefix=False):
    eos = V - 1
    aug = pkb.TCPGenBatchAugmenter(
        WORDS, {2, 5, 7, 8, 10} if prefix else BOUNDARY, eos, eos,
        prefix_boundary=prefix, kb_len=5, db_drop=0.0, sched_epochs=3,
        seed=7)
    return aug.augment({"text": text}, epoch)


@pytest.fixture(scope="module")
def asr_case():
    pcfg, jcfg = _configs()
    jmodel = JASRModel(jcfg)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[2, 4, 6, 7, 9, 11], [5, 6, 13, 2, 3, -1]], np.int32)
    extra = _augmented_batch(text)
    batch = dict(speech=x, speech_lengths=lens, text=text,
                 text_lengths=(text >= 0).sum(1).astype(np.int32))
    trie = {k: extra[k].numpy() for k in (*TRIE_KEYS, "node", "p_gen_mask")}
    params = jax.jit(lambda rng: jmodel.init(rng, **batch, **trie))(
        jax.random.PRNGKey(0))["params"]
    return jmodel, jax.tree.map(np.asarray, params), pcfg, batch, extra


@pytest.mark.parametrize("labels", [True, False])
def test_tcpgen_asr_loss_stats_and_gradients_match(asr_case, labels):
    jmodel, params, pcfg, batch, extra = asr_case
    extra = {k: v.numpy() for k, v in extra.items() if k != "text"}
    if not labels:
        extra = {k: v for k, v in extra.items()
                 if k not in ("ptr_label_mask", "smoothprob_scale")}
    else:
        assert (extra["ptr_label_mask"] == 1).any()
        assert float(extra["smoothprob_scale"]) == pytest.approx(2 / 3)

    def jloss(p):
        return jmodel.apply({"params": p}, train=True, **batch, **extra)

    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = ASRModel(pcfg, device="cpu")
    model.load_state_dict(flax_to_torch(params))
    loss, stats = model(**{k: t(v) for k, v in {**batch, **extra}.items()},
                        train=True)
    want = {"loss_ctc", "loss_att", "acc", "loss", "p_gen"}
    if labels:
        want |= {"p_gen_bias", "loss_ptr", "loss_gate"}
    assert set(stats) == set(ref_stats) == want
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    loss.backward()
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_g))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = grads[name].grad
        assert g is not None, name
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((g - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
    assert float(ref["tcpgen.pointer_gate.weight"].abs().max()) > 0


def test_tcpgen_asr_without_a_trie_is_the_plain_loss(asr_case):
    """A use_tcpgen model on a batch without a trie takes the plain CE, as
    the reference's (TCPGen's parameters get no gradient)."""
    jmodel, params, pcfg, batch, _ = asr_case
    ref_loss, _ = jax.jit(lambda p: jmodel.apply({"params": p}, train=True,
                                                 **batch))(params)
    model = ASRModel(pcfg, device="cpu")
    model.load_state_dict(flax_to_torch(params))
    loss, stats = model(**{k: t(v) for k, v in batch.items()}, train=True)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert "p_gen" not in stats
    loss.backward()
    assert all(p.grad is None for p in model.tcpgen.parameters())


# --- the biased beam search ------------------------------------------------

@pytest.mark.parametrize("prefix,force", [(False, None), (True, None),
                                          (False, 0.8)])
def test_biased_beam_search_matches(asr_case, prefix, force):
    jmodel, params, pcfg, batch, _ = asr_case
    trie = jkb.build_trie(WORDS)
    bset = {2, 5, 7, 8, 10} if prefix else BOUNDARY
    bmask = np.zeros(V + 1, bool)
    bmask[list(bset)] = True
    common = dict(boundary_mask=bmask, prefix_boundary=prefix,
                  dead=trie.dead, smoothprob=0.9, force_p_gen=force)
    beam = dict(beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8)

    @jax.jit
    def run(params, speech, lens):
        hs, hl, _ = jmodel.apply({"params": params}, speech, lens,
                                 method=lambda m, s, sl: m.encode(s, sl))
        return j_beam(jmodel, params, hs, hl, JBeamConfig(**beam),
                      biasing=dict(common, trie=_trie_dict(trie),
                                   boundary_mask=jnp.asarray(bmask)),
                      return_nbest=True)

    ref = jax.tree.map(np.asarray, run(params, batch["speech"],
                                       batch["speech_lengths"]))
    model = ASRModel(pcfg, device="cpu")
    model.load_state_dict(flax_to_torch(params))
    hs, hl = model.encode(t(batch["speech"]), t(batch["speech_lengths"]))
    got = batch_beam_search(
        model, hs, hl, BeamSearchConfig(**beam),
        biasing=dict(common, trie=_trie_dict(trie, as_torch=True),
                     boundary_mask=torch.from_numpy(bmask)),
        return_nbest=True)
    for i, what in enumerate(("tokens", "lengths", "n-best tokens",
                              "n-best lengths")):
        np.testing.assert_array_equal(got[i].numpy(), ref[i], err_msg=what)
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=1e-4)
    unbiased = batch_beam_search(model, hs, hl, BeamSearchConfig(**beam),
                                 return_nbest=True)
    assert not np.allclose(unbiased[4].numpy(), got[4].numpy())


def _selection(arch, trie, lm_hooks):
    """A selection LM over the word trie of WORDS (word ids 2-9): an LSTM
    of vocabulary 10 whose logits choose among class roots (the global root
    and the subtrees under tokens 2, 5 and 7), or a stateless table."""
    kids = dict(zip(trie.children_tok[0][:trie.n_children[0]].tolist(),
                    trie.children_node[0][:trie.n_children[0]].tolist()))
    roots = np.array([0, kids[2], kids[5], kids[7]] * 3)[:10]
    if arch == "table":
        table = np.random.RandomState(2).randn(10, 10).astype(np.float32)
        jt, pt = jnp.asarray(table), torch.from_numpy(table)
        hooks = ((lambda w, st: (jt[w], st),
                  lambda n: jnp.zeros((n,), jnp.int32)),
                 (lambda w, st: (pt[w], st), lambda n: torch.zeros(n).long()))
    else:
        hooks = lm_hooks(10)
    return [{"word_trie": build(WORDS, list(range(2, 10))), "word_unk": 1,
             "sel_step": h[0], "sel_init": h[1], "class_roots": roots}
            for build, h in ((jwl.build_word_trie, hooks[0]),
                             (pwl.build_word_trie, hooks[1]))]


def _lstm_lm_hooks(vocab, max_len=8):
    """(reference, port) make_lm_fusion hooks of one LSTM LM (flax init,
    converted)."""
    from espnet_slurp_tpu.models import lm as jlm
    from espnet_slurp_tpu.tasks.lm import make_lm_fusion as j_fusion
    from espnet_slurp_tpu_torch.models import lm as plm
    from espnet_slurp_tpu_torch.tasks.lm import make_lm_fusion as p_fusion
    widths = dict(vocab_size=vocab, arch="lstm", d_model=8, num_layers=1)
    jm = jlm.LSTMLM(jlm.LMConfig(**widths))
    lp = jax.jit(lambda r: jm.init(r, np.zeros((1, 2), np.int32),
                                   np.array([2])))(jax.random.PRNGKey(3))
    pm = plm.LSTMLM(plm.LMConfig(**widths), device="cpu")
    pm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray,
                                                  lp["params"])))
    return j_fusion(jm, lp["params"], 0, max_len), p_fusion(pm, max_len)


@pytest.mark.parametrize("arch,with_lm", [("table", False), ("lstm", True)])
def test_selection_lm_biased_beam_search_matches(asr_case, arch, with_lm):
    """biasing["selection"] (the selection LM's KB-class choice at word
    boundaries, resetting trie_step's root): tokens, lengths and n-best
    equal to the reference's, n-best scores within 1e-4; with an LSTM
    selection LM whose carry is kept at word boundaries only, beside an
    LSTM LM in shallow fusion (ILM asked for, and ignored under biasing
    by both)."""
    jmodel, params, pcfg, batch, _ = asr_case
    trie = jkb.build_trie(WORDS)
    bmask = np.zeros(V + 1, bool)
    bmask[list(BOUNDARY)] = True
    jsel, psel = _selection(arch, trie, _lstm_lm_hooks)
    common = dict(prefix_boundary=False, dead=trie.dead, smoothprob=0.9)
    beam = dict(beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8)
    fusion = dict(zip(("j", "p"), _lstm_lm_hooks(V))) if with_lm else {}
    lm_args = lambda side: (dict(lm_step=fusion[side][0],
                                 lm_init=fusion[side][1]) if with_lm else {})
    weights = dict(lm_weight=0.4 * with_lm, ilm_weight=0.3 * with_lm)

    @jax.jit
    def run(params, speech, lens):
        hs, hl, _ = jmodel.apply({"params": params}, speech, lens,
                                 method=lambda m, s, sl: m.encode(s, sl))
        return j_beam(jmodel, params, hs, hl, JBeamConfig(**weights, **beam),
                      biasing=dict(common, trie=_trie_dict(trie),
                                   boundary_mask=jnp.asarray(bmask),
                                   selection=jsel),
                      return_nbest=True, **lm_args("j"))

    ref = jax.tree.map(np.asarray, run(params, batch["speech"],
                                       batch["speech_lengths"]))
    model = ASRModel(pcfg, device="cpu")
    model.load_state_dict(flax_to_torch(params))
    hs, hl = model.encode(t(batch["speech"]), t(batch["speech_lengths"]))
    biasing = dict(common, trie=_trie_dict(trie, as_torch=True),
                   boundary_mask=torch.from_numpy(bmask))
    got = batch_beam_search(
        model, hs, hl, BeamSearchConfig(**weights, **beam),
        biasing=dict(biasing, selection=psel), return_nbest=True,
        **lm_args("p"))
    for i, what in enumerate(("tokens", "lengths", "n-best tokens",
                              "n-best lengths")):
        np.testing.assert_array_equal(got[i].numpy(), ref[i], err_msg=what)
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=1e-4)
    # the class roots moved the walk: the search differs from one without
    # the selection LM
    plain = batch_beam_search(
        model, hs, hl, BeamSearchConfig(**weights, **beam),
        biasing=biasing, return_nbest=True, **lm_args("p"))
    assert not np.allclose(plain[4].numpy(), got[4].numpy())


# --- the KB-aware transducer ------------------------------------------------

def test_kb_transducer_loss_and_gradients_match():
    from espnet_slurp_tpu.models import transducer as jtd
    from espnet_slurp_tpu_torch.models.transducer import (TransducerConfig,
                                                          TransducerModel)
    asr = dict(ASR, ctc_weight=0.0, use_tcpgen=False)
    pa, ja = _configs(**asr)
    head = dict(pred_dim=24, joint_dim=40, aux_ctc_weight=0.3,
                use_tcpgen=True)
    jm = jtd.TransducerModel(jtd.TransducerConfig(asr=ja, **head))
    x, lens = waveforms([4096, 3000], seed=5)
    text = np.asarray([[2, 4, 6, 7, 9], [5, 6, 13, 2, -1]], np.int32)
    tl = (text >= 0).sum(1).astype(np.int32)
    extra = _augmented_batch(text)
    extra = {k: extra[k].numpy() for k in (*TRIE_KEYS, "node", "p_gen_mask")}
    batch = dict(speech=x, speech_lengths=lens, text=text, text_lengths=tl)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda rng: jm.init(rng, **batch, **extra))(
        jax.random.PRNGKey(0))["params"])

    def jloss(p):
        return jm.apply({"params": p}, train=True, **batch, **extra)

    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = TransducerModel(TransducerConfig(asr=pa, **head), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    loss, stats = model(**{k: t(v) for k, v in {**batch, **extra}.items()},
                        train=True)
    assert set(stats) == set(ref_stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    loss.backward()
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_g))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((grads[name].grad - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
    assert float(ref["tcpgen.Kproj.weight"].abs().max()) > 0
