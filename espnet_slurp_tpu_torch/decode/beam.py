"""Batched label-synchronous joint CTC/attention beam search.

Port of espnet_slurp_tpu/decode/beam.py:batch_beam_search: fixed-shape
[B, K] hypothesis state, decoder scores on the whole vocabulary, CTC prefix
scores on a pre-beam of P candidates (eos always forced into the last slot),
length bonus, ended hypotheses frozen proposing only eos at delta 0, and eos
forced on the last step. The reference's ``lax.while_loop`` is a Python loop
that stops once every hypothesis has ended.

TCPGen biasing (``biasing``): each hypothesis carries its trie node, the
pointer's distribution is mixed into the decoder's scores every step
(models/tcpgen.py), and the node advances by the vectorised ``trie_step``
(the fork's per-hypothesis dict walk, decoders.py:recognize_beam, as
gathers). Shallow-fusion LMs, internal-LM subtraction and the biasing
selection LM (``biasing["selection"]``) are not ported yet and raise
(ROADMAP.md queue 1 item 11); internal-LM subtraction is off under
biasing, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.asr_model import ASRModel
from ..models.tcpgen import tcpgen_final_logprobs, trie_step
from . import ctc_prefix
from .greedy import eos_lengths, init_decoder_cache

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
                      return_nbest: bool = False) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens [B, max_len] eos-padded, lengths [B]) of the best
    hypotheses; with ``return_nbest`` also the ranked beam (nb_tokens
    [B, K, L], nb_lengths [B, K], nb_scores [B, K]).

    ``biasing`` enables TCPGen contextual biasing (a model with
    ``use_tcpgen``): {"trie": {trie_token, trie_children_tok,
    trie_children_node, trie_n_children tensors}, "boundary_mask": [V+1]
    bool tensor, "dead": int, "prefix_boundary": bool, "smoothprob":
    float, "force_p_gen": float or None}; ``force_p_gen`` pins p_gen
    where the walk is live (a diagnostic of the reference's)."""
    if (lm_step is not None or lm_init is not None or cfg.lm_weight > 0.0
            or (cfg.ilm_weight > 0.0 and biasing is None)):
        raise NotImplementedError("LM / internal-LM fusion is not ported "
                                  "yet (ROADMAP.md queue 1 item 11)")
    if biasing is not None and biasing.get("selection") is not None:
        raise NotImplementedError(
            "biasing['selection'] (the selection-LM KB choice, "
            "decode/word_lm.py) is not ported yet (ROADMAP.md queue 1 item "
            "11)")
    mcfg = model.cfg
    dev = hs.device
    b = hs.shape[0]
    k, l = cfg.beam_size, cfg.max_len
    v = mcfg.vocab_size
    p = min(cfg.pre_beam_size, v)
    sos, eos, blank = mcfg.sos_id, mcfg.eos_id, mcfg.blank_id
    w_ctc = cfg.ctc_weight
    w_att = 1.0 - w_ctc
    n = b * k

    mem_kv = {name: {kv: x.repeat_interleave(k, dim=0) for kv, x in m.items()}
              for name, m in model.decoder.precompute_memory(hs).items()}
    h_lengths_beam = h_lengths.repeat_interleave(k)
    use_ctc = w_ctc > 0.0
    if use_ctc:
        ctc_lp_beam = model.ctc_logprobs(hs).repeat_interleave(k, dim=0)
        ctc = ctc_prefix.init_state(ctc_lp_beam, h_lengths_beam, blank)
    cache = init_decoder_cache(model, n, l)
    if biasing is not None:
        trie = {key: x.to(dev) for key, x in biasing["trie"].items()}
        tree_encs = model.tcpgen_tree_encs(trie)
        boundary = biasing["boundary_mask"].to(dev)
        node = torch.zeros(n, dtype=torch.long, device=dev)
        pmask = torch.zeros(n, dtype=torch.long, device=dev)
        force = biasing.get("force_p_gen")

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
        if biasing is None:
            logits, cache = model.decoder.step(y_prev.reshape(n), i, cache,
                                               mem_kv, h_lengths_beam, l)
            att_lp = torch.log_softmax(logits.float(), dim=-1)
        else:
            logits, cache, hidden = model.decoder.step(
                y_prev.reshape(n), i, cache, mem_kv, h_lengths_beam, l,
                return_hidden=True)
            ptr_dist, kb_emb = model.tcpgen(hidden, node, trie, tree_encs)
            if force is None:
                p_gen = model.tcpgen.gen_prob(
                    hidden, kb_emb, pmask, biasing.get("smoothprob", 1.0))
            else:
                p_gen = torch.where(pmask > 0, 0.0, float(force))
            att_lp = tcpgen_final_logprobs(logits, ptr_dist, p_gen)
        fused = att_lp * w_att
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

        cache = {name: {kv: x[parent_n] for kv, x in c.items()}
                 for name, c in cache.items()}
        if use_ctc:
            new = ctc_prefix.select(r_new, psi_new, cand, parent_n, choice_n)
            e = ended.reshape(n)
            ctc = ctc_prefix.CTCPrefixState(
                r=torch.where(e[:, None, None], ctc.r[parent_n], new.r),
                psi=torch.where(e, ctc.psi[parent_n], new.psi),
                last=torch.where(e, ctc.last[parent_n], new.last))
        if biasing is not None:
            node, pmask = trie_step(
                trie, node[parent_n], tok.reshape(n), boundary, eos,
                biasing["dead"],
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
