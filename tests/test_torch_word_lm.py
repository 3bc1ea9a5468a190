"""The port's word-level fusions (decode/word_lm.py) against the
reference's hooks on the CPU, fp32: build_word_trie's tables equal; the
LookAhead and MultiLevel rows over two token streams that cross word
boundaries, enter the open-vocabulary (dead) node and end in eos, equal
within 1e-5 (log-probs; LOGZERO entries exactly), with a stateless table
word LM and with an LSTM word LM whose carry is kept only at word
boundaries (its flax parameters converted); select_class_roots' choice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.decode import word_lm as jwl
from espnet_slurp_tpu.models import lm as jlm
from espnet_slurp_tpu.tasks.lm import make_lm_fusion as j_lm_fusion
from espnet_slurp_tpu_torch.decode import word_lm as pwl
from espnet_slurp_tpu_torch.models import lm as plm
from espnet_slurp_tpu_torch.tasks.lm import make_lm_fusion as p_lm_fusion
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

V, SPACE, EOS = 10, 8, 9   # subword vocabulary, boundary, eos
W, W_UNK, W_EOS = 6, 1, 5  # word vocabulary: 0 pad, 1 unk, 2-4 words, 5 eos
WORDS, WIDS = [[3, 4], [3, 5], [6]], [2, 3, 4]
BOUNDARY = np.zeros(V, bool)
BOUNDARY[SPACE] = True
# two hypotheses: words, an unknown start (7: dead), a dead walk off a
# known prefix (3, 2), a word closed early (3 then space), eos
STREAMS = np.array([[3, 4, 8, 6, 8, 7, 2, 8, 3, 5, 8, 9],
                    [6, 8, 3, 2, 8, 3, 8, 3, 4, 4, 8, 9]])
TOL = 1e-5
FIELDS = ("children_tok", "children_node", "n_children", "wid", "lo", "hi")


def test_build_word_trie_matches():
    words = [[3, 4], [3, 5], [6], [3, 4, 7], [2]]
    for wids, skip in ((None, ()), ([2, 3, 4, 6, 7], (4,))):
        ref = jwl.build_word_trie(words, wids, skip)
        got = pwl.build_word_trie(words, wids, skip)
        assert got.dead == ref.dead
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)


def _table_lms(rows, seed):
    table = np.random.RandomState(seed).randn(rows, rows).astype(np.float32)
    jt, pt = jnp.asarray(table), torch.from_numpy(table)
    return ((lambda w, st: (jt[w], st), lambda n: jnp.zeros((n,), jnp.int32)),
            (lambda w, st: (pt[w], st), lambda n: torch.zeros(n).long()))


def _lstm_lms(vocab, seed):
    jc = jlm.LMConfig(vocab_size=vocab, arch="lstm", d_model=8, num_layers=2)
    jm = jlm.LSTMLM(jc)
    ys = np.zeros((1, 2), np.int32)
    params = jm.init(jax.random.PRNGKey(seed), ys, np.array([2]))["params"]
    pm = plm.LSTMLM(plm.LMConfig(vocab_size=vocab, arch="lstm", d_model=8,
                                 num_layers=2), device="cpu")
    pm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return j_lm_fusion(jm, params, 0, 16), p_lm_fusion(pm, 16)


def _run(jhooks, phooks):
    (jstep, jinit), (pstep, pinit) = jhooks, phooks
    jstep = jax.jit(jstep)
    jst, pst = jax.jit(jinit, static_argnums=0)(2), pinit(2)
    for t in range(STREAMS.shape[1]):
        ref, jst = jstep(jnp.asarray(STREAMS[:, t]), jst)
        got, pst = pstep(torch.from_numpy(STREAMS[:, t]), pst)
        ref, got = np.asarray(ref), got.numpy()
        low = ref <= jwl.LOGZERO
        np.testing.assert_array_equal(got <= pwl.LOGZERO, low, f"step {t}")
        np.testing.assert_allclose(got[~low], ref[~low], atol=TOL, rtol=TOL,
                                   err_msg=f"step {t}")
    return pst


@pytest.mark.parametrize("word_lm", ["table", "lstm"])
def test_lookahead_rows_match(word_lm):
    trie_args = dict(vocab_size=V, space_id=SPACE, eos_id=EOS,
                     boundary_mask=BOUNDARY, word_eos=W_EOS, word_unk=W_UNK)
    jw, pw = _table_lms(W, 0) if word_lm == "table" else _lstm_lms(W, 0)
    jtrie = jwl.build_word_trie(WORDS, WIDS)
    ptrie = pwl.build_word_trie(WORDS, WIDS)
    last = _run(jwl.make_lookahead_fusion(*jw, trie=jtrie, **trie_args),
                pwl.make_lookahead_fusion(*pw, trie=ptrie, device="cpu",
                                          **trie_args))
    # eos is no edge of the trie: both walks end in the dead node
    assert last["node"].tolist() == [ptrie.dead] * 2


@pytest.mark.parametrize("lms", ["table", "lstm"])
def test_multilevel_rows_match(lms):
    trie_args = dict(vocab_size=V, space_id=SPACE, eos_id=EOS,
                     boundary_mask=BOUNDARY, word_eos=W_EOS, word_unk=W_UNK,
                     subwordlm_weight=0.8, oov_penalty=0.5)
    if lms == "table":
        jw, pw = _table_lms(W, 1)
        js, ps = _table_lms(V, 2)
    else:
        jw, pw = _lstm_lms(W, 1)
        js, ps = _lstm_lms(V, 2)
    _run(jwl.make_multilevel_fusion(
             *jw, *js, trie=jwl.build_word_trie(WORDS, WIDS), **trie_args),
         pwl.make_multilevel_fusion(
             *pw, *ps, trie=pwl.build_word_trie(WORDS, WIDS), device="cpu",
             **trie_args))


def test_select_class_roots_matches():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 4).astype(np.float32)
    logits[0, 1] = logits[0, 2] = 5.0  # a tie: the first index wins
    roots = np.array([10, 20, 30, 40])
    mask = np.array([False, True, False, False])
    for m in (None, mask):
        ref = jwl.select_class_roots(
            jnp.asarray(logits), jnp.asarray(roots),
            None if m is None else jnp.asarray(m))
        got = pwl.select_class_roots(
            torch.from_numpy(logits), torch.from_numpy(roots),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
