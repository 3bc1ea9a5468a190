"""Word-level LM fusion for subword beam search: LookAhead / MultiLevel,
and the selection LM's class choice.

Port of espnet_slurp_tpu/decode/word_lm.py (reference espnet/lm/
pytorch_backend/extlm.py: LookAheadWordLM :118-210, MultiLevelLM :18-115;
the lexical tree of espnet/lm/lm_utils.py:make_lexical_tree:274-293).
``WordTrie`` and ``build_word_trie`` are host numpy, copied; the walk and
the scorers are torch on the decode's device. The scorers are batched
``lm_step(y_prev [N], state) -> (logp [N, V], state)`` hooks of
decode/beam.py's shallow fusion. Every hypothesis advances in lockstep: the
word LM steps every label, and its new state is selected only for the
hypotheses at a word boundary (so the word LM's ``step`` must leave its old
state as it was: models/lm.py's do).

Semantics per step (LookAheadWordLM.forward):
  * boundary token (space / word-piece ending in the boundary marker): feed
    the finished word (node wid, else <unk>) to the word LM; cumsum <-
    softmax; node <- root.
  * else intra-word: node <- child(node, token), or the open-vocabulary
    (dead) node when there is no path.
  * output log-probs: children get (cumsum[hi] - cumsum[lo]) / sum_prob,
    default = unk_prob * oov_penalty, boundary / eos columns get the
    word-end probability; open-vocabulary nodes emit zeros (transition
    probability 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.tree import tree_map

LOGZERO = -1e10
ZERO = 1e-10


@dataclasses.dataclass
class WordTrie:
    """Flat lexical tree over the WORD vocabulary.

    children_tok[n, k]: subword id of edge k from node n; children_node
    likewise; wid[n]: word id if node n ends a word else -1;
    lo[n], hi[n]: word-id range of the subtree (make_lexical_tree's
    ``(wid-1, wid)`` min/max convention — sum of subtree word probs is
    cumsum[hi] - cumsum[lo]). Node 0 = root, ``dead`` = open-vocab sink.
    """
    children_tok: np.ndarray
    children_node: np.ndarray
    n_children: np.ndarray
    wid: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    dead: int


def build_word_trie(word_subwords: Sequence[Sequence[int]],
                    word_ids: Optional[Sequence[int]] = None,
                    skip: Sequence[int] = ()) -> WordTrie:
    """word_subwords[i] = subword-id sequence of word with id word_ids[i]
    (default: i). Mirrors make_lexical_tree (lm_utils.py:274-293).

    Do NOT include the boundary token in the sequences — the boundary
    CLOSES a word (its probability comes from the word-end override), and
    an in-word boundary edge would be clobbered by that override. Also mark
    sos in ``boundary_mask`` when decoding so hypotheses start at the word
    root (the reference init treats start-of-sentence as <space>).
    """
    if word_ids is None:
        word_ids = list(range(len(word_subwords)))
    nodes = [{"succ": {}, "wid": -1, "lo": 10 ** 9, "hi": -1}]

    def new_node():
        nodes.append({"succ": {}, "wid": -1, "lo": 10 ** 9, "hi": -1})
        return len(nodes) - 1

    for seq, wid in zip(word_subwords, word_ids):
        if wid in skip:
            continue
        cur = 0
        for i, c in enumerate(seq):
            succ = nodes[cur]["succ"]
            if c not in succ:
                succ[c] = new_node()
            cur = succ[c]
            nodes[cur]["lo"] = min(nodes[cur]["lo"], wid - 1)
            nodes[cur]["hi"] = max(nodes[cur]["hi"], wid)
            if i == len(seq) - 1:
                nodes[cur]["wid"] = wid
    dead = new_node()
    n = len(nodes)
    mb = max(1, max(len(nd["succ"]) for nd in nodes))
    ct = np.full((n, mb), -1, np.int32)
    cn = np.zeros((n, mb), np.int32)
    nc = np.zeros((n,), np.int32)
    wid = np.full((n,), -1, np.int32)
    lo = np.zeros((n,), np.int32)
    hi = np.zeros((n,), np.int32)
    for i, nd in enumerate(nodes):
        for k, (c, child) in enumerate(sorted(nd["succ"].items())):
            ct[i, k] = c
            cn[i, k] = child
        nc[i] = len(nd["succ"])
        wid[i] = nd["wid"]
        lo[i] = 0 if nd["lo"] == 10 ** 9 else nd["lo"]
        hi[i] = max(nd["hi"], 0)
    return WordTrie(ct, cn, nc, wid, lo, hi, dead)


def trie_tensors(t: WordTrie, device) -> Dict[str, torch.Tensor]:
    """The trie's tables as long tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(a)).long().to(device) for k, a in
            (("ct", t.children_tok), ("cn", t.children_node),
             ("nc", t.n_children), ("wid", t.wid), ("lo", t.lo),
             ("hi", t.hi))}


def _walk(trie_t: Dict[str, torch.Tensor], node: torch.Tensor,
          y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched intra-word walk: (child(node, y) or -1, found). [N] -> [N]."""
    mb = trie_t["ct"].shape[1]
    ct, cn, nc = trie_t["ct"][node], trie_t["cn"][node], trie_t["nc"][node]
    valid = torch.arange(mb, device=node.device)[None, :] < nc[:, None]
    hit = (ct == y[:, None]) & valid
    found = hit.any(dim=1)
    child = torch.where(hit, cn, torch.zeros_like(cn)).sum(dim=1)
    return torch.where(found, child, torch.full_like(child, -1)), found


def _child_vocab_scatter(trie_t, node, values, default, vocab_size: int):
    """Per-child values [N, MB] scattered into the subword vocabulary axis
    over ``default`` [N]; column V takes the padding slots."""
    mb = trie_t["ct"].shape[1]
    ct, nc = trie_t["ct"][node], trie_t["nc"][node]
    valid = torch.arange(mb, device=node.device)[None, :] < nc[:, None]
    tok = torch.where(valid, ct, torch.full_like(ct, vocab_size))
    y = default[:, None].expand(node.shape[0], vocab_size + 1)
    y = y.scatter(1, tok, torch.where(valid, values, 0.0))
    return y[:, :vocab_size]


def _select(is_b: torch.Tensor, new, old):
    """The state ``new`` where is_b [N], else ``old``, leaf by leaf."""
    return tree_map(lambda a, b: torch.where(
        is_b.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), new, old)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for x [N, W], idx [N]."""
    return x.gather(1, idx[:, None])[:, 0]


def make_lookahead_fusion(
    wordlm_step: Callable, wordlm_init: Callable, *,
    trie: WordTrie, vocab_size: int, space_id: int, eos_id: int,
    boundary_mask: np.ndarray, word_eos: int, word_unk: int,
    oov_penalty: float = 1e-4, device=None,
) -> Tuple[Callable, Callable]:
    """(lm_step, lm_init) hooks implementing LookAheadWordLM, on ``device``
    (the card unless given).

    wordlm_step(w_prev [N], state) -> (logits [N, W], state) over the WORD
    vocabulary (e.g. tasks/lm.py:make_lm_fusion's hooks); boundary_mask:
    [V] bool marking the word-boundary subword tokens (space included).
    """
    dev = resolve_device(device)
    tt = trie_tensors(trie, dev)
    bnd = torch.as_tensor(np.asarray(boundary_mask), device=dev)
    bcols = (bnd | (torch.arange(vocab_size, device=dev) == eos_id))[None, :]

    def _advance(wlm_state, w):
        logits, st = wordlm_step(w, wlm_state)
        return st, torch.cumsum(torch.softmax(logits.float(), -1), -1)

    def lm_init(n):
        st, cum = _advance(wordlm_init(n), torch.full(
            (n,), word_eos, dtype=torch.long, device=dev))
        return {"wlm": st, "cum": cum,
                "node": torch.zeros(n, dtype=torch.long, device=dev)}

    def lm_step(y_prev, state):
        y_prev = y_prev.long()
        node, cum, wlm = state["node"], state["cum"], state["wlm"]
        n = y_prev.shape[0]
        is_b = bnd[y_prev]
        # a boundary token closes the word at the current node
        wid_here = tt["wid"][node]
        w = torch.where(wid_here >= 0, wid_here, word_unk)
        new_wlm, new_cum = _advance(wlm, w)
        wlm = _select(is_b, new_wlm, wlm)
        cum = torch.where(is_b[:, None], new_cum, cum)
        child, found = _walk(tt, node, y_prev)
        node = torch.where(is_b, 0, torch.where(found, child, trie.dead))
        open_vocab = node == trie.dead

        # the look-ahead distribution from the (possibly new) node
        sum_prob = torch.where(node == 0, 1.0, _at(cum, tt["hi"][node])
                               - _at(cum, tt["lo"][node]))
        unk_prob = cum[:, word_unk] - cum[:, max(word_unk - 1, 0)]
        child_nodes = tt["cn"][node]
        child_p = (cum.gather(1, tt["hi"][child_nodes])
                   - cum.gather(1, tt["lo"][child_nodes])) \
            / sum_prob.clamp_min(ZERO)[:, None]
        y = _child_vocab_scatter(tt, node, child_p, unk_prob * oov_penalty,
                                 vocab_size)
        # boundary / eos columns: the word-end probability at this node;
        # at a fresh root (just after a boundary) ZERO; mid-word at a node
        # that ends no word the unk default (extlm.py:198-205)
        wid_new = tt["wid"][node]
        w_end = torch.where(
            wid_new >= 0,
            (_at(cum, wid_new.clamp_min(0))
             - _at(cum, (wid_new - 1).clamp_min(0)))
            / sum_prob.clamp_min(ZERO),
            torch.where(is_b, ZERO, unk_prob * oov_penalty))
        y = torch.where(bcols, w_end[:, None], y)
        logp = torch.log(y.clamp_min(ZERO))
        logp = torch.where((sum_prob < ZERO)[:, None], LOGZERO, logp)
        logp = torch.where(open_vocab[:, None], 0.0, logp)
        return logp, {"wlm": wlm, "cum": cum, "node": node}

    return lm_step, lm_init


def make_multilevel_fusion(
    wordlm_step: Callable, wordlm_init: Callable,
    subwordlm_step: Callable, subwordlm_init: Callable, *,
    trie: WordTrie, vocab_size: int, space_id: int, eos_id: int,
    boundary_mask: np.ndarray, word_eos: int, word_unk: int,
    subwordlm_weight: float = 0.8, oov_penalty: float = 1.0, device=None,
) -> Tuple[Callable, Callable]:
    """(lm_step, lm_init) hooks implementing MultiLevelLM, on ``device``
    (the card unless given): subword-LM scores within words, the word LM's
    probability injected at word boundaries minus the accumulated subword
    log-prob of the word. That sum scores ``y_prev`` with the previous
    step's (weighted) subword distribution (``prev_lp``), as the
    reference's stored log_y (extlm.py:74, 79)."""
    dev = resolve_device(device)
    tt = trie_tensors(trie, dev)
    bnd = torch.as_tensor(np.asarray(boundary_mask), device=dev)
    bcols = (bnd | (torch.arange(vocab_size, device=dev) == eos_id))[None, :]
    log_oov = float(np.log(oov_penalty))

    def lm_init(n):
        wlm_logits, wlm = wordlm_step(
            torch.full((n,), word_eos, dtype=torch.long, device=dev),
            wordlm_init(n))
        return {"wlm": wlm,
                "wlp": torch.log_softmax(wlm_logits.float(), -1),
                "slm": subwordlm_init(n),
                "node": torch.zeros(n, dtype=torch.long, device=dev),
                "acc": torch.zeros(n, device=dev),
                "prev_lp": torch.zeros(n, vocab_size, device=dev)}

    def lm_step(y_prev, state):
        y_prev = y_prev.long()
        node, acc = state["node"], state["acc"]
        wlm, wlp = state["wlm"], state["wlp"]
        is_b = bnd[y_prev]
        wid_here = tt["wid"][node]
        w = torch.where(wid_here >= 0, wid_here, word_unk)
        new_logits, new_wlm = wordlm_step(w, wlm)
        new_wlp = torch.log_softmax(new_logits.float(), -1)
        wlm = _select(is_b, new_wlm, wlm)
        wlp = torch.where(is_b[:, None], new_wlp, wlp)

        s_logits, slm = subwordlm_step(y_prev, state["slm"])
        log_y = torch.log_softmax(s_logits.float(), -1) * subwordlm_weight

        child, found = _walk(tt, node, y_prev)
        node = torch.where(is_b, 0, torch.where(found, child, trie.dead))
        tok_lp = _at(state["prev_lp"], y_prev)
        acc = torch.where(is_b, 0.0, acc + tok_lp)

        wid_new = tt["wid"][node]
        w_lp = torch.where(wid_new >= 0,
                           _at(wlp, wid_new.clamp_min(0)) - acc,
                           wlp[:, word_unk] + log_oov)
        out = torch.where(bcols, torch.where(is_b[:, None], LOGZERO,
                                             w_lp[:, None]), log_y)
        return out, {"wlm": wlm, "wlp": wlp, "slm": slm, "node": node,
                     "acc": acc, "prev_lp": log_y}

    return lm_step, lm_init


def select_class_roots(class_logits: torch.Tensor, class_roots: torch.Tensor,
                       class_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Selection-LM KB choice (asr_recog.py --select --classlm, topk=1,
    decoders.py:1074-1097): per-hypothesis class posterior -> biasing-trie
    reset root. class_logits [N, C]; class_roots [C] -> roots [N].
    class_mask: True EXCLUDES a class (an already-used or disallowed KB
    class)."""
    if class_mask is not None:
        class_logits = torch.where(class_mask[None, :], -1e9, class_logits)
    return class_roots[class_logits.argmax(dim=-1)]
