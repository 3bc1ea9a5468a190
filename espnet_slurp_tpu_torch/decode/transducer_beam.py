"""Batched transducer beam searches. Port of
espnet_slurp_tpu/decode/transducer_beam.py.

Three search bodies, each on fixed-size [B, K] hypothesis state as the
reference keeps it (its lax.while_loop / fori_loop become eager loops over
frames here):

- ``transducer_beam_search`` (ALSA): alignment-length synchronous; every
  iteration each hypothesis either takes blank (its frame pointer advances)
  or emits one of its top ``pre_beam_size`` labels.
- ``default_beam_search`` (Graves 2012): per frame, pop the best active
  hypothesis, put its blank extension into the kept pool and its top label
  extensions back into the active pool, until K kept hypotheses outscore
  the best active one (at most ``max_expansions`` pops a frame).
- ``_frame_sync_search`` behind ``maes_search``, ``tsd_search`` and
  ``nsc_search``: per frame, ``nstep`` expansion rounds, then a forced blank
  settles the hypotheses still active.

Each returns (tokens [B, max_len] blank-padded, lengths [B]), and with
``with_score=True`` also the chosen hypothesis's log-probability score [B]
(fp32), which the reference keeps inside its loops. Selections
break ties by index, lower first, as ``lax.top_k`` and ``jnp.argmax`` do: the
pools are padded with NEG scores, so ties are common and an unordered top-k
would let the beams drift from the reference's. The loops whose trip count
depends on the data (ALSA's, and default's per-frame pops) read one value
from the device per iteration, counted in utils/device.py:host_syncs. The
joint and prediction networks run in eager PyTorch, as the reference runs
them outside any kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.transducer import TransducerModel
from ..utils import device as device_mod

NEG = -1e30


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, equal values in index order (lower
    first), as ``lax.top_k`` orders them."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _map_carry(f, carry):
    return [tuple(f(x) for x in layer) for layer in carry]


def _where_carry(mask: torch.Tensor, new, old):
    """Per-row select of two carries: new where ``mask`` [N]."""
    return [tuple(torch.where(mask[:, None], a, b) for a, b in zip(ln, lo))
            for ln, lo in zip(new, old)]


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


@dataclasses.dataclass(frozen=True)
class TransducerBeamConfig:
    beam_size: int = 5
    pre_beam_size: int = 5  # non-blank expansions considered per hypothesis
    max_len: int = 128


@torch.inference_mode()
def transducer_beam_search(model: TransducerModel, hs: torch.Tensor,
                           h_lengths: torch.Tensor, cfg: TransducerBeamConfig,
                           with_score: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """ALSA: every iteration, each of the B x K hypotheses takes blank
    (consumes its frame) or emits a label; the K best of the K x (P + 1)
    candidates a row survive. Ends when every hypothesis has consumed its
    frames (or after T + max_len + 1 iterations); the best finished one."""
    a = model.cfg.asr
    b, t_max, _ = hs.shape
    k, l = cfg.beam_size, cfg.max_len
    p = min(cfg.pre_beam_size, a.vocab_size - 1)
    blank, n, dev = a.blank_id, b * k, hs.device
    pred = model.prediction
    hs_beam = hs.repeat_interleave(k, 0)
    h_len_beam = h_lengths.to(dev).repeat_interleave(k, 0)
    g, carry = pred.step(torch.full((n,), blank, dtype=torch.long,
                                    device=dev), pred.init_carry(n, dev))
    score = torch.full((b, k), NEG, device=dev)
    score[:, 0] = 0.0
    tokens = torch.full((b, k, l), blank, dtype=torch.long, device=dev)
    n_emit = torch.zeros(b, k, dtype=torch.long, device=dev)
    t = torch.zeros(b, k, dtype=torch.long, device=dev)
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    pos = torch.arange(l, device=dev)
    frozen = torch.cat([torch.zeros(n, 1, device=dev),
                        torch.full((n, p), NEG, device=dev)], 1)
    it = 0
    while it < t_max + l + 1 and not device_mod.host_bool(done.all()):
        h_t = hs_beam[rows, t.reshape(n).clamp(0, t_max - 1)]
        logp = _log_softmax(model.joint(h_t, g))
        blank_delta = logp[:, blank]
        nb = logp.clone()
        nb[:, blank] = NEG
        tok_delta, tok_ids = topk(nb, p)
        can_emit = (n_emit.reshape(n) < l)[:, None]
        tok_delta = torch.where(can_emit, tok_delta,
                                torch.full_like(tok_delta, NEG))
        deltas = torch.cat([blank_delta[:, None], tok_delta], 1)
        done_n = done.reshape(n)
        deltas = torch.where(done_n[:, None], frozen, deltas)
        totals = score.reshape(n)[:, None] + deltas
        score, idx = topk(totals.reshape(b, k * (p + 1)), k)
        parent = idx // (p + 1)
        choice = (idx % (p + 1)).reshape(n)
        parent_n = (parent + torch.arange(b, device=dev)[:, None] * k
                    ).reshape(n)
        is_blank = choice == 0
        chosen = tok_ids[parent_n].gather(
            1, (choice - 1).clamp_min(0)[:, None])[:, 0]
        chosen = torch.where(is_blank, torch.full_like(chosen, blank), chosen)
        t_new = t.reshape(n)[parent_n] + is_blank.long()
        done_new = done_n[parent_n] | (t_new >= h_len_beam[parent_n])
        n_emit_g = n_emit.reshape(n)[parent_n]
        emit = ~is_blank & ~done_n[parent_n]
        tokens_g = tokens.reshape(n, l)[parent_n]
        write = emit[:, None] & (pos[None, :]
                                 == n_emit_g.clamp(max=l - 1)[:, None])
        tokens = torch.where(write, chosen[:, None], tokens_g).reshape(b, k, l)
        n_emit = (n_emit_g + emit.long()).reshape(b, k)
        g_g, carry_g = g[parent_n], _map_carry(lambda x: x[parent_n], carry)
        g_upd, carry_upd = pred.step(
            torch.where(emit, chosen, torch.full_like(chosen, blank)), carry_g)
        g = torch.where(emit[:, None], g_upd, g_g)
        carry = _where_carry(emit, carry_upd, carry_g)
        t, done = t_new.reshape(b, k), done_new.reshape(b, k)
        it += 1
    final = torch.where(done, score, score + NEG)
    best = final.argmax(1)
    r = torch.arange(b, device=dev)
    out = tokens[r, best], n_emit[r, best]
    return out + (final[r, best],) if with_score else out


@dataclasses.dataclass(frozen=True)
class MAESConfig:
    """modified Adaptive Expansion Search (beam_search_transducer.py:
    720-877)."""
    beam_size: int = 5
    nstep: int = 2  # expansion rounds per frame
    max_candidates: int = 5  # candidates considered per round
    expansion_gamma: float = 2.3  # prune-by-value window per hypothesis
    max_len: int = 128


def maes_search(model, hs, h_lengths, cfg: MAESConfig, with_score=False):
    """mAES: frame-synchronous, up to ``nstep`` expansion rounds a frame,
    each hypothesis's candidates pruned to within ``expansion_gamma`` of its
    best (blank included)."""
    return _frame_sync_search(
        model, hs, h_lengths, beam_size=cfg.beam_size, nstep=cfg.nstep,
        max_candidates=cfg.max_candidates, gamma=cfg.expansion_gamma,
        max_len=cfg.max_len, with_score=with_score)


@dataclasses.dataclass(frozen=True)
class TSDConfig:
    """Time-synchronous decoding (beam_search_transducer.py:356-451)."""
    beam_size: int = 5
    max_sym_exp: int = 2  # symbol expansions per frame
    max_len: int = 128


def tsd_search(model, hs, h_lengths, cfg: TSDConfig, with_score=False):
    """TSD (Saon et al.): up to ``max_sym_exp`` rounds a frame over the
    top ``beam_size`` candidates, no pruning by value."""
    return _frame_sync_search(
        model, hs, h_lengths, beam_size=cfg.beam_size, nstep=cfg.max_sym_exp,
        max_candidates=cfg.beam_size, gamma=None, max_len=cfg.max_len,
        with_score=with_score)


@dataclasses.dataclass(frozen=True)
class NSCConfig:
    """N-step constrained beam search (beam_search_transducer.py:557-719)."""
    beam_size: int = 5
    nstep: int = 2
    max_candidates: int = 5
    max_len: int = 128


def nsc_search(model, hs, h_lengths, cfg: NSCConfig, with_score=False):
    """NSC (Kim et al. 2020): ``nstep`` rounds a frame over
    ``max_candidates`` labels, then a forced blank."""
    return _frame_sync_search(
        model, hs, h_lengths, beam_size=cfg.beam_size, nstep=cfg.nstep,
        max_candidates=cfg.max_candidates, gamma=None, max_len=cfg.max_len,
        with_score=with_score)


@dataclasses.dataclass(frozen=True)
class DefaultBeamConfig:
    """Graves-2012 ``default`` beam search (beam_search_transducer.py:
    255-355)."""
    beam_size: int = 5
    max_len: int = 128
    # Pops a frame are capped (the reference's bound for its fixed-shape
    # loop; the stop test almost always ends a frame first).
    max_expansions: int = 12


Pool = Dict[str, object]  # tokens [B, C, L], ne [B, C], score [B, C],
# g [B*C, P], carry (per layer (c, h) of [B*C, P])


@torch.inference_mode()
def default_beam_search(model: TransducerModel, hs: torch.Tensor,
                        h_lengths: torch.Tensor, cfg: DefaultBeamConfig,
                        with_score: bool = False) -> Tuple[torch.Tensor, ...]:
    """Per frame: repeatedly pop each row's best active hypothesis, merge
    its blank extension into the kept pool (top K) and its top labels into
    the active pool (capacity A = K + E (K' - 1) + 1, so nothing live is
    pruned within E pops); a row is done once K kept hypotheses outscore
    its best active one. The reference's fixed pools, score NEG for an
    empty slot; no prefix merge, as there."""
    a = model.cfg.asr
    b, t_max, _ = hs.shape
    k, l, e = cfg.beam_size, cfg.max_len, cfg.max_expansions
    blank, dev = a.blank_id, hs.device
    bk = min(k, a.vocab_size - 1)
    aa = k + e * (bk - 1) + 1
    pred = model.prediction
    h_len = h_lengths.to(dev)
    g0, carry0 = pred.step(torch.full((b,), blank, dtype=torch.long,
                                      device=dev), pred.init_carry(b, dev))
    p = g0.shape[-1]
    rows = torch.arange(b, device=dev)
    pos = torch.arange(l, device=dev)

    def tile(x, cap):
        return x.repeat_interleave(cap, 0)

    def gather_pool(pool, idx, cap) -> Pool:
        m = idx.shape[1]
        flat = (idx + rows[:, None] * cap).reshape(b * m)
        return dict(tokens=pool["tokens"].reshape(b * cap, l)[flat]
                    .reshape(b, m, l),
                    ne=pool["ne"].reshape(b * cap)[flat].reshape(b, m),
                    score=pool["score"].gather(1, idx),
                    g=pool["g"][flat],
                    carry=_map_carry(lambda x: x[flat], pool["carry"]))

    def concat_pools(p1, c1, p2, c2) -> Pool:
        def cat(x, y):
            return torch.cat([x.reshape((b, c1) + x.shape[1:]),
                              y.reshape((b, c2) + y.shape[1:])], 1
                             ).reshape((b * (c1 + c2),) + x.shape[1:])
        return dict(tokens=torch.cat([p1["tokens"], p2["tokens"]], 1),
                    ne=torch.cat([p1["ne"], p2["ne"]], 1),
                    score=torch.cat([p1["score"], p2["score"]], 1),
                    g=cat(p1["g"], p2["g"]),
                    carry=[tuple(cat(x, y) for x, y in zip(l1, l2))
                           for l1, l2 in zip(p1["carry"], p2["carry"])])

    def topk_pool(pool, cap_in, m) -> Pool:
        sc, idx = topk(pool["score"], m)
        out = gather_pool(pool, idx, cap_in)
        out["score"] = sc
        return out

    def freeze(done, new, old) -> Pool:
        """old where a row is done, new elsewhere, leaf by leaf."""
        def sel(nw, od):
            m = done if nw.shape[0] == b else done.repeat_interleave(
                nw.shape[0] // b)
            return torch.where(m.reshape((-1,) + (1,) * (nw.ndim - 1)),
                               od, nw)
        return dict(tokens=sel(new["tokens"], old["tokens"]),
                    ne=sel(new["ne"], old["ne"]),
                    score=sel(new["score"], old["score"]),
                    g=sel(new["g"], old["g"]),
                    carry=[tuple(sel(x, y) for x, y in zip(ln, lo))
                           for ln, lo in zip(new["carry"], old["carry"])])

    score0 = torch.full((b, k), NEG, device=dev)
    score0[:, 0] = 0.0
    kept = dict(tokens=torch.full((b, k, l), blank, dtype=torch.long,
                                  device=dev),
                ne=torch.zeros(b, k, dtype=torch.long, device=dev),
                score=score0, g=tile(g0, k),
                carry=_map_carry(lambda x: tile(x, k), carry0))
    pad = dict(tokens=torch.full((b, aa - k, l), blank, dtype=torch.long,
                                 device=dev),
               ne=torch.zeros(b, aa - k, dtype=torch.long, device=dev),
               score=torch.full((b, aa - k), NEG, device=dev),
               g=tile(g0, aa - k),
               carry=_map_carry(lambda x: tile(x, aa - k), carry0))
    for t in range(t_max):
        h_t = hs[:, t]
        done = t >= h_len
        act = concat_pools(kept, k, pad, aa - k)
        kept = dict(kept, score=torch.where(
            done[:, None], kept["score"],
            torch.full_like(kept["score"], NEG)))
        it = 0
        while it < e and not device_mod.host_bool(done.all()):
            h_idx = act["score"].argmax(1)
            star = gather_pool(act, h_idx[:, None], aa)
            s_star = star["score"][:, 0]
            lp = _log_softmax(model.joint(h_t, star["g"]))
            blank_lp = lp[:, blank]
            nb = lp.clone()
            nb[:, blank] = NEG
            tok_delta, tok_ids = topk(nb, bk)
            bchild = dict(star, score=torch.where(
                done, torch.full_like(s_star, NEG),
                s_star + blank_lp)[:, None])
            kept_new = topk_pool(concat_pools(kept, k, bchild, 1), k + 1, k)
            can = (star["ne"][:, 0] < l) & ~done
            child_sc = torch.where(can[:, None], s_star[:, None] + tok_delta,
                                   torch.full_like(tok_delta, NEG))
            g_ch, carry_ch = pred.step(
                tok_ids.reshape(b * bk),
                _map_carry(lambda x: x.repeat_interleave(bk, 0),
                           star["carry"]))
            wp = star["ne"].clamp(max=l - 1)
            tok_b = star["tokens"].repeat_interleave(bk, 1)
            tokens_ch = torch.where(pos[None, None, :] == wp[:, :, None],
                                    tok_ids[:, :, None], tok_b)
            children = dict(tokens=tokens_ch,
                            ne=star["ne"].repeat_interleave(bk, 1) + 1,
                            score=child_sc, g=g_ch, carry=carry_ch)
            popped = ((torch.arange(aa, device=dev)[None, :]
                       == h_idx[:, None]) & ~done[:, None])
            act_cl = dict(act, score=torch.where(
                popped, torch.full_like(act["score"], NEG), act["score"]))
            act_new = topk_pool(concat_pools(act_cl, aa, children, bk),
                                aa + bk, aa)
            hyps_max = act_new["score"].max(1).values
            n_better = (kept_new["score"] > hyps_max[:, None]).sum(1)
            act, kept = (freeze(done, act_new, act),
                         freeze(done, kept_new, kept))
            done = done | (n_better >= k)
            it += 1
    best = kept["score"].argmax(1)
    out = gather_pool(kept, best[:, None], k)
    best = out["tokens"][:, 0], out["ne"][:, 0]
    return best + (out["score"][:, 0],) if with_score else best


@torch.inference_mode()
def _frame_sync_search(model: TransducerModel, hs: torch.Tensor,
                       h_lengths: torch.Tensor, *, beam_size: int, nstep: int,
                       max_candidates: int, gamma: Optional[float],
                       max_len: int, with_score: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """The frame-synchronous search behind mAES / TSD / NSC on a fixed
    [B, K] beam with a per-hypothesis ``settled`` flag: a settled hypothesis
    took blank this frame and only carries (delta 0) for the remaining
    rounds; after the last round the others settle with a forced blank. No
    prefix merge or duplicate check, as in the reference. ``gamma`` is
    mAES's prune-by-value window; None keeps every top candidate (TSD,
    NSC). Its loops run a fixed number of times: no host sync."""
    a = model.cfg.asr
    b, t_max, _ = hs.shape
    k, l = beam_size, max_len
    mc = min(max_candidates, a.vocab_size)
    blank, n, dev = a.blank_id, b * k, hs.device
    pred = model.prediction
    hs_beam = hs.repeat_interleave(k, 0)
    h_len_beam = h_lengths.to(dev).repeat_interleave(k, 0)
    g, carry = pred.step(torch.full((n,), blank, dtype=torch.long,
                                    device=dev), pred.init_carry(n, dev))
    score = torch.full((b, k), NEG, device=dev)
    score[:, 0] = 0.0
    tokens = torch.full((b, k, l), blank, dtype=torch.long, device=dev)
    n_emit = torch.zeros(b, k, dtype=torch.long, device=dev)
    offs = torch.arange(b, device=dev)[:, None] * k
    pos = torch.arange(l, device=dev)
    for t in range(t_max):
        h_t = hs_beam[:, t]
        settled = ~(t < h_len_beam).reshape(b, k)
        for _ in range(nstep):
            lp = _log_softmax(model.joint(h_t, g))
            blank_lp = lp[:, blank]
            nb = lp.clone()
            nb[:, blank] = NEG
            topv, topi = topk(nb, mc)
            can_emit = (n_emit.reshape(n) < l)[:, None]
            neg = torch.full_like(topv, NEG)
            if gamma is not None:
                best = torch.maximum(topv[:, 0], blank_lp)
                keep = topv >= (best - gamma)[:, None]
                exp_delta = torch.where(keep & can_emit, topv, neg)
                settle_delta = torch.where(blank_lp >= best - gamma, blank_lp,
                                           torch.full_like(blank_lp, NEG))
            else:
                exp_delta = torch.where(can_emit, topv, neg)
                settle_delta = blank_lp
            s_n = settled.reshape(n)
            slot0 = torch.where(s_n, torch.zeros_like(settle_delta),
                                settle_delta)
            deltas = torch.cat([slot0[:, None],
                                torch.where(s_n[:, None], neg, exp_delta)], 1)
            totals = score.reshape(n)[:, None] + deltas
            score, idx = topk(totals.reshape(b, k * (mc + 1)), k)
            parent_n = (idx // (mc + 1) + offs).reshape(n)
            choice = (idx % (mc + 1)).reshape(n)
            is_carry = choice == 0
            settled = (s_n[parent_n] | is_carry).reshape(b, k)
            tok = topi[parent_n].gather(
                1, (choice - 1).clamp_min(0)[:, None])[:, 0]
            emit = ~is_carry
            tokens_g = tokens.reshape(n, l)[parent_n]
            n_emit_g = n_emit.reshape(n)[parent_n]
            write = emit[:, None] & (pos[None, :]
                                     == n_emit_g.clamp(max=l - 1)[:, None])
            tokens = torch.where(write, tok[:, None],
                                 tokens_g).reshape(b, k, l)
            n_emit = (n_emit_g + emit.long()).reshape(b, k)
            g_g = g[parent_n]
            carry_g = _map_carry(lambda x: x[parent_n], carry)
            g_upd, carry_upd = pred.step(
                torch.where(emit, tok, torch.full_like(tok, blank)), carry_g)
            g = torch.where(emit[:, None], g_upd, g_g)
            carry = _where_carry(emit, carry_upd, carry_g)
        lp = _log_softmax(model.joint(h_t, g))
        score = score + torch.where(settled, torch.zeros_like(score),
                                    lp[:, blank].reshape(b, k))
    best = score.argmax(1)
    r = torch.arange(b, device=dev)
    out = tokens[r, best], n_emit[r, best]
    return out + (score[r, best],) if with_score else out


SEARCHES = ("greedy", "alsa", "default", "maes", "tsd", "nsc")


def run_search(model: TransducerModel, hs: torch.Tensor,
               h_lengths: torch.Tensor, search: str, beam_size: int,
               max_len: int, with_score: bool = False
               ) -> Tuple[torch.Tensor, ...]:
    """The search named ``search`` (one of SEARCHES) at ``beam_size`` with
    each config's other defaults; ``beam_size <= 1`` is greedy, as the
    reference's Speech2TextTransducer dispatches. ``with_score`` (the beam
    searches only) also returns the chosen hypotheses' scores."""
    from ..models.transducer import transducer_greedy_decode
    if search not in SEARCHES:
        raise ValueError(f"search {search!r}: one of {SEARCHES}")
    if beam_size <= 1 or search == "greedy":
        if with_score:
            raise ValueError("with_score: greedy decoding keeps no score")
        return transducer_greedy_decode(model, hs, h_lengths,
                                        max_len=max_len)
    fn, cfg = {
        "alsa": (transducer_beam_search,
                 TransducerBeamConfig(beam_size, max_len=max_len)),
        "default": (default_beam_search,
                    DefaultBeamConfig(beam_size, max_len)),
        "maes": (maes_search, MAESConfig(beam_size, max_len=max_len)),
        "tsd": (tsd_search, TSDConfig(beam_size, max_len=max_len)),
        "nsc": (nsc_search, NSCConfig(beam_size, max_len=max_len)),
    }[search]
    return fn(model, hs, h_lengths, cfg, with_score=with_score)
