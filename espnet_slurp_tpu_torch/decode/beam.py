"""Batched label-synchronous joint CTC/attention beam search.

Port of espnet_slurp_tpu/decode/beam.py:batch_beam_search: fixed-shape
[B, K] hypothesis state, decoder scores on the whole vocabulary, CTC prefix
scores on a pre-beam of P candidates (eos always forced into the last slot),
length bonus, ended hypotheses frozen proposing only eos at delta 0, and eos
forced on the last step. Every decoder's cache (the KV cache, a conv
decoder's GLU rings, the LAS decoder's LSTM states and attention weights
``att_prev``) is gathered leaf by leaf along the back-pointers. The
reference's ``lax.while_loop`` is a Python loop that stops once every
hypothesis has ended.

Shallow fusion (``lm_step`` / ``lm_init``, reference :240-245): the scorer's
log-probs join the decoder's as ``att_lp * (1 - ctc_weight) + lm_weight *
lm_lp``; its state (a Transformer LM's 2 x num_blocks K/V caches, an LSTM's
carry, an n-gram's context, nested dicts / lists of tensors) is gathered
along the beam's back-pointers every step, also for ended hypotheses,
which the reference does not freeze either. Internal-LM subtraction
(``ilm_weight``, :221-233) runs the decoder a second time against the
zeroed encoder memory with its own cache (with every decoder: the LAS
decoder's attends over zeros) and scores
``log p_att - ilm_weight * log p_ilm``; it is off under biasing, as in the
reference, and skipped at weight 0, where the reference's pass changes no
score (``ilm_weight * log p_ilm`` is 0).

TCPGen biasing (``biasing``): each hypothesis carries its trie node, the
pointer's distribution is mixed into the decoder's scores every step
(models/tcpgen.py), and the node advances by the vectorised ``trie_step``
(the fork's per-hypothesis dict walk, decoders.py:recognize_beam, as
gathers). ``biasing["selection"]`` adds the selection LM's KB-class choice
(:331-357): a walk of the word trie (decode/word_lm.py), and at each word
boundary the selection LM steps on the finished word and its argmax class's
root becomes the hypothesis's reset root of ``trie_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.asr_model import ASRModel
from ..models.tcpgen import tcpgen_final_logprobs, trie_step
from ..utils.tree import tree_map
from . import ctc_prefix
from .greedy import eos_lengths, init_decoder_cache
from .word_lm import _select, _walk, select_class_roots, trie_tensors

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 10
    pre_beam_size: int = 30  # P, including the forced eos slot
    max_len: int = 128
    ctc_weight: float = 0.3
    lm_weight: float = 0.0
    length_bonus: float = 0.0
    ilm_weight: float = 0.0


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def batch_beam_search(model: ASRModel, hs: torch.Tensor,
                      h_lengths: torch.Tensor, cfg: BeamSearchConfig,
                      lm_step=None, lm_init=None, biasing=None,
                      return_nbest: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens [B, max_len] eos-padded, lengths [B]) of the best
    hypotheses; with ``return_nbest`` also the ranked beam (nb_tokens
    [B, K, L], nb_lengths [B, K], nb_scores [B, K]).

    ``lm_step(y_prev [N], state) -> (log-probs [N, V], state)`` and
    ``lm_init(N) -> state`` (N = B K) enable shallow fusion at
    ``cfg.lm_weight``; ``cfg.ilm_weight`` > 0 the internal-LM
    subtraction. (The reference's ``lm_weight`` / ``ilm_weight``
    arguments, there to trace the weights into one compiled program, are
    the config's fields here.)

    ``biasing`` enables TCPGen contextual biasing (a model with
    ``use_tcpgen``): {"trie": {trie_token, trie_children_tok,
    trie_children_node, trie_n_children tensors}, "boundary_mask": [V+1]
    bool tensor, "dead": int, "prefix_boundary": bool, "smoothprob":
    float, "force_p_gen": float or None}; ``force_p_gen`` pins p_gen
    where the walk is live (a diagnostic of the reference's). An optional
    "selection": {"word_trie": decode/word_lm.py WordTrie, "word_unk": int,
    "sel_step": (word ids [N], state) -> (class logits [N, C], state),
    "sel_init": N -> state, "class_roots": [C] ints} chooses each
    hypothesis's KB class at its word boundaries."""
    mcfg = model.cfg
    dev = hs.device
    b = hs.shape[0]
    k, l = cfg.beam_size, cfg.max_len
    v = mcfg.vocab_size
    p = min(cfg.pre_beam_size, v)
    sos, eos, blank = mcfg.sos_id, mcfg.eos_id, mcfg.blank_id
    w_ctc = cfg.ctc_weight
    w_att = 1.0 - w_ctc
    w_lm, w_ilm = cfg.lm_weight, cfg.ilm_weight
    n = b * k

    def beam_memory(x):
        return tree_map(lambda y: y.repeat_interleave(k, dim=0),
                        model.decoder.precompute_memory(x))

    mem_kv = beam_memory(hs)
    h_lengths_beam = h_lengths.repeat_interleave(k)
    use_ilm = biasing is None and w_ilm > 0.0
    if use_ilm:
        # the same decoder against a zeroed memory: cross-attention sees
        # only the memory projections' biases
        mem_kv_zero = beam_memory(torch.zeros_like(hs))
    use_ctc = w_ctc > 0.0
    if use_ctc:
        ctc_lp_beam = model.ctc_logprobs(hs).repeat_interleave(k, dim=0)
        ctc = ctc_prefix.init_state(ctc_lp_beam, h_lengths_beam, blank)
    t_enc = hs.shape[1]
    cache = init_decoder_cache(model, n, l, t_enc, h_lengths_beam)
    if use_ilm:
        # the ILM pass's layer inputs part from the main pass's after the
        # first cross-attention: it keeps its own self-attention cache
        cache = {"main": cache, "ilm": init_decoder_cache(
            model, n, l, t_enc, h_lengths_beam)}
    lm_state = lm_init(n) if lm_init is not None else None
    use_lm = lm_step is not None and w_lm > 0.0
    sel = None if biasing is None else biasing.get("selection")
    if biasing is not None:
        trie = {key: x.to(dev) for key, x in biasing["trie"].items()}
        tree_encs = model.tcpgen_tree_encs(trie)
        boundary = biasing["boundary_mask"].to(dev)
        node = torch.zeros(n, dtype=torch.long, device=dev)
        pmask = torch.zeros(n, dtype=torch.long, device=dev)
        force = biasing.get("force_p_gen")
    if sel is not None:
        wtrie = trie_tensors(sel["word_trie"], dev)
        class_roots = torch.as_tensor(sel["class_roots"]).long().to(dev)
        root = torch.zeros(n, dtype=torch.long, device=dev)
        word_node = torch.zeros(n, dtype=torch.long, device=dev)
        sel_state = sel["sel_init"](n)

    total = torch.full((b, k), NEG, device=dev)
    total[:, 0] = 0.0
    tokens = torch.full((b, k, l), eos, dtype=torch.long, device=dev)
    att = torch.zeros(b, k, device=dev)
    ended = torch.zeros(b, k, dtype=torch.bool, device=dev)
    y_prev = torch.full((b, k), sos, dtype=torch.long, device=dev)
    batch_off = (torch.arange(b, device=dev) * k)[:, None]
    eos_slot = torch.arange(p, device=dev) == p - 1
    frozen = torch.where(eos_slot, 0.0, NEG).expand(n, p)
    eos_col = torch.full((n, 1), eos, dtype=torch.long, device=dev)

    for i in range(l):
        if bool(ended.all()):
            break
        y_n = y_prev.reshape(n)
        if biasing is not None:
            logits, cache, hidden = model.decoder.step(
                y_n, i, cache, mem_kv, h_lengths_beam, l, return_hidden=True)
            ptr_dist, kb_emb = model.tcpgen(hidden, node, trie, tree_encs)
            if force is None:
                p_gen = model.tcpgen.gen_prob(
                    hidden, kb_emb, pmask, biasing.get("smoothprob", 1.0))
            else:
                p_gen = torch.where(pmask > 0, 0.0, float(force))
            att_lp = tcpgen_final_logprobs(logits, ptr_dist, p_gen)
        elif use_ilm:
            logits, main = model.decoder.step(y_n, i, cache["main"], mem_kv,
                                              h_lengths_beam, l)
            ilm_logits, ilm = model.decoder.step(
                y_n, i, cache["ilm"], mem_kv_zero, h_lengths_beam, l)
            cache = {"main": main, "ilm": ilm}
            att_lp = (torch.log_softmax(logits.float(), dim=-1)
                      - w_ilm * torch.log_softmax(ilm_logits.float(), dim=-1))
        else:
            logits, cache = model.decoder.step(y_n, i, cache, mem_kv,
                                               h_lengths_beam, l)
            att_lp = torch.log_softmax(logits.float(), dim=-1)
        fused = att_lp * w_att
        if use_lm:
            lm_lp, lm_state = lm_step(y_n, lm_state)
            fused = fused + w_lm * lm_lp
        # Pre-beam: top-(P-1) without eos, then the forced eos slot, so eos
        # is never a candidate twice.
        _, cand = _top_k(fused.index_fill(1, torch.tensor([eos], device=dev),
                                          NEG), p - 1)
        cand = torch.cat([cand, eos_col], dim=1)  # [N, P]
        delta = fused.gather(1, cand)
        if use_ctc:
            psi_new, r_new = ctc_prefix.score_candidates(
                ctc, ctc_lp_beam, h_lengths_beam, cand, i, blank)
            fin = ctc_prefix.final_score(ctc, h_lengths_beam)
            ctc_cand = torch.where(cand == eos, fin[:, None], psi_new)
            # blank is not a prefix extension (ctc_prefix_score.py:185-186)
            ctc_cand = torch.where(cand == blank, NEG, ctc_cand)
            delta = delta + w_ctc * (ctc_cand - ctc.psi[:, None])
        delta = delta + cfg.length_bonus
        delta = torch.where(ended.reshape(n, 1), frozen, delta)
        if i == l - 1:  # force eos so every hypothesis terminates
            delta = torch.where(eos_slot, delta, NEG)

        totals = total.reshape(n, 1) + delta
        total_new, idx = _top_k(totals.reshape(b, k * p), k)
        parent = idx // p  # [B, K]
        choice = idx % p
        parent_n = (parent + batch_off).reshape(n)
        choice_n = choice.reshape(n)
        tok = cand[parent_n, choice_n].reshape(b, k)
        tokens = tokens.gather(1, parent[..., None].expand(b, k, l))
        tokens[:, :, i] = tok
        step_att = att_lp.gather(1, cand)[parent_n, choice_n].reshape(b, k)
        ended_parent = ended.gather(1, parent)
        att_parent = att.gather(1, parent)
        # frozen hypotheses accumulate nothing
        att = torch.where(ended_parent, att_parent, att_parent + step_att)
        ended = ended_parent | (tok == eos)

        gather_n = lambda x: x[parent_n]
        cache = tree_map(gather_n, cache)
        lm_state = tree_map(gather_n, lm_state)
        if use_ctc:
            new = ctc_prefix.select(r_new, psi_new, cand, parent_n, choice_n)
            e = ended.reshape(n)
            ctc = ctc_prefix.CTCPrefixState(
                r=torch.where(e[:, None, None], ctc.r[parent_n], new.r),
                psi=torch.where(e, ctc.psi[parent_n], new.psi),
                last=torch.where(e, ctc.last[parent_n], new.last))
        tok_n = tok.reshape(n)
        if sel is not None:
            # the word-trie walk, and the selection LM's class choice at
            # each word boundary
            wnode_g = word_node[parent_n]
            is_b = boundary[tok_n]
            wid_here = wtrie["wid"][wnode_g]
            w = torch.where(wid_here >= 0, wid_here, sel["word_unk"])
            sel_state_g = tree_map(gather_n, sel_state)
            cls_logits, sel_new = sel["sel_step"](w, sel_state_g)
            sel_state = _select(is_b, sel_new, sel_state_g)
            root = torch.where(is_b, select_class_roots(cls_logits,
                                                        class_roots),
                               root[parent_n])
            child, found = _walk(wtrie, wnode_g, tok_n)
            word_node = torch.where(is_b, 0, torch.where(
                found, child, sel["word_trie"].dead))
        if biasing is not None:
            node, pmask = trie_step(
                trie, node[parent_n], tok_n, boundary, eos, biasing["dead"],
                root=root if sel is not None else 0,
                prefix_boundary=biasing.get("prefix_boundary", False))
        total, y_prev = total_new, tok

    best = total.argmax(dim=1)
    best_tokens = tokens[torch.arange(b, device=dev), best]
    lengths = eos_lengths(best_tokens, eos)
    if not return_nbest:
        return best_tokens, lengths
    order = torch.argsort(-total, dim=1, stable=True)
    nb_tokens = tokens.gather(1, order[..., None].expand(b, k, l))
    return (best_tokens, lengths, nb_tokens, eos_lengths(nb_tokens, eos),
            total.gather(1, order))
