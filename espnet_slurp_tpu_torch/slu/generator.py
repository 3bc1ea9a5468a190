"""KA2G slot-value generator: slot classification + per-slot value
generation with TCPGen over ontology tries.

Port of espnet_slurp_tpu/slu/generator.py: ``SlotGenConfig``,
``build_ontology_forest``, ``GPT2JointText``, ``SlotValueDecoder``,
``SlotGenerator`` (``classify``, ``forward``, ``generate``) and
``walk_forest``. Parity target of the reference: the fork's
espnet/nets/pytorch_backend/KB_utils/SLU.py (SLUGenNet :658-1346, a
slot-value generator over GPT-2 hidden states with per-slot TCPGen over
slot ontology trees).

Slots are a batch axis: every slot of every utterance is classified and
decoded at once ([B * n_slots] rows), and the per-slot ontology tries are
one forest trie whose slot roots sit under virtual tokens, so one TCPGen
serves every slot through a per-row root node. Modules and parameters
carry the flax names (``slot_query``, ``value_decoder.n1_{i}``,
``sa_{i}``, ``xa_{i}``, ``ff_{i}`` ...), so utils/params.py maps a
reference tree onto them. Parameters are fp32 and every layer computes in
``dtype``; the classification BCE and the losses are fp32. Nothing here is
a kernel in the reference: plain tensor ops.

One reference fault is not copied (ROADMAP.md queue 3): the oracle
pointer and gate losses are taken on the LIVE walk steps, ``p_gen_mask ==
0`` (the reference's ``> 0`` selects the dead steps, where walk_forest
disabled the pointer and ``gen_prob`` is 0). ``generate`` is the
reference's greedy decode step for step; the reference's low entity F1
(queue 3) is undiagnosed, so the port shares it if it lies there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.conformer import LN_EPS
from ..models.embedding import abs_positional_encoding
from ..models.hf_transformer import (GPT2Config, GPT2Model,
                                     gpt2_config_from_dir,
                                     gpt2_state_dict_from_dir)
from ..models.layers import LayerNorm, Linear
from ..models.tcpgen import TCPGen, tcpgen_final_logprobs, trie_step
from ..models.transformer import CachedAttention, FeedForward
from ..ops.masks import attention_bias, causal_mask, length_mask
from .kb import FlatTrie, build_trie

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SlotGenConfig:
    n_slots: int = 16
    value_vocab_size: int = 1000   # shares the SLU token vocab
    d_model: int = 256
    n_head: int = 4
    d_ff: int = 1024
    num_blocks: int = 2
    max_value_len: int = 16
    use_tcpgen: bool = True
    gcn_layers: int = 2
    tree_encoder: str = "gcn"  # gcn | gat | sage | treelstm
    # Oracle pointer / gate supervision on live walk steps: every training
    # value is in the ontology, so "point at the target child and open the
    # gate wherever the walk is live" is the exact oracle (the reference's
    # note: without it the gate collapses).
    ptr_loss_weight: float = 0.5
    gate_loss_weight: float = 0.2
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def build_ontology_forest(
    slot_values: Sequence[Sequence[Sequence[int]]],
    pad_nodes_multiple: int = 64,
) -> Tuple[FlatTrie, np.ndarray]:
    """Per-slot ontology value lists -> one forest trie + per-slot roots.

    slot_values[s] = list of subword-id sequences for slot s's legal
    values. Each value is prefixed with the virtual token -s-1, so the
    forest is one flat trie and roots[s] is the child of the global root
    under that token (the trie's dead node when slot s has no value). The
    global root is never queried: a walk starts at a slot root."""
    prefixed = []
    for s, values in enumerate(slot_values):
        for v in values:
            prefixed.append([-(s + 1)] + list(v))
    trie = build_trie(prefixed, pad_nodes_multiple)
    roots = np.zeros((len(slot_values),), np.int32)
    for s in range(len(slot_values)):
        row = trie.children_tok[0, :trie.n_children[0]]
        hit = np.nonzero(row == -(s + 1))[0]
        roots[s] = trie.children_node[0, hit[0]] if hit.size else trie.dead
    return trie, roots


class GPT2JointText(nn.Module):
    """GPT-2 hidden states over the (first-pass) transcript, projected to
    ``d_model``, as the slot generator's joint text representation (the
    fork's modality/roberta.py GPT2_encoder). With ``hf_dir`` the GPT-2
    takes that HF directory's config.json, and ``load_hf_weights`` loads
    its weights (the reference grafts them under params['gpt2'])."""

    def __init__(self, vocab_size: int, d_model: int,
                 hf_dir: Optional[str] = None, n_layer: int = 2,
                 n_head: int = 4, n_embd: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hf_dir = hf_dir
        if hf_dir:
            gcfg = gpt2_config_from_dir(hf_dir)
        else:
            gcfg = GPT2Config(vocab_size=vocab_size, n_embd=n_embd,
                              n_layer=n_layer, n_head=n_head,
                              n_positions=512)
        self.gpt2 = GPT2Model(gcfg, dtype=dtype)
        self.proj = Linear(gcfg.n_embd, d_model)

    def load_hf_weights(self) -> None:
        """The GPT-2's weights from ``hf_dir`` (fp32 masters)."""
        sd = gpt2_state_dict_from_dir(self.hf_dir, self.gpt2.cfg)
        self.gpt2.load_state_dict(
            {k: v.to(self.proj.weight.device) for k, v in sd.items()})

    def forward(self, tokens, lengths):
        """tokens [B, L], lengths [B] -> (states [B, L, d_model] with the
        padding zeroed, mask [B, L])."""
        mask = length_mask(lengths.to(tokens.device), tokens.shape[1])
        hs = self.proj(self.gpt2(tokens, mask.int()))
        return torch.where(mask[..., None], hs, torch.zeros_like(hs)), mask


class SlotValueDecoder(nn.Module):
    """Pre-norm Transformer decoder over the memory, batched per slot: the
    value embedding plus the slot's embedding, abs positions, causal self-
    attention, cross-attention and a relu FFN a block."""

    def __init__(self, cfg: SlotGenConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.d_model
        self.dtype = c.torch_dtype
        self.embed = nn.Embedding(c.value_vocab_size, d)
        self.slot_embed = nn.Embedding(c.n_slots, d)
        for i in range(c.num_blocks):
            self.add_module(f"n1_{i}", LayerNorm(d, eps=LN_EPS))
            self.add_module(f"sa_{i}", CachedAttention(c.n_head, d))
            self.add_module(f"n2_{i}", LayerNorm(d, eps=LN_EPS))
            self.add_module(f"xa_{i}", CachedAttention(c.n_head, d))
            self.add_module(f"n3_{i}", LayerNorm(d, eps=LN_EPS))
            self.add_module(f"ff_{i}", FeedForward(d, c.d_ff))
        self.after_norm = LayerNorm(d, eps=LN_EPS)
        self.output = Linear(d, c.value_vocab_size)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens.long()).to(self.dtype)

    def forward(self, ys_in, slot_ids, memory, memory_mask):
        """ys_in [N, L] (N = B * n_slots); slot_ids [N]; memory [N, T, D],
        memory_mask [N, T] -> (logits [N, L, V], hidden [N, L, D])."""
        l = ys_in.shape[1]
        x = (self.embed_tokens(ys_in)
             + self.slot_embed(slot_ids.long()).to(self.dtype)[:, None, :])
        x = abs_positional_encoding(x, scale=True)
        self_bias = attention_bias(causal_mask(l, x.device)[None, None])
        mem_bias = attention_bias(memory_mask[:, None, None, :])
        memory = memory.to(self.dtype)
        for i in range(self.cfg.num_blocks):
            m = lambda name: getattr(self, f"{name}_{i}")
            h = m("n1")(x)
            x = x + m("sa")(h, h, self_bias)
            x = x + m("xa")(m("n2")(x), memory, mem_bias)
            x = x + m("ff")(m("n3")(x))
        hidden = self.after_norm(x)
        return self.output(hidden), hidden


class SlotGenerator(nn.Module):
    """Slot presence classification + value generation (+ ontology
    TCPGen)."""

    def __init__(self, cfg: SlotGenConfig):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = c.torch_dtype
        self.slot_query = nn.Embedding(c.n_slots, c.d_model)
        self.slot_attn = CachedAttention(c.n_head, c.d_model)
        self.classifier = Linear(c.d_model, 1)
        self.value_decoder = SlotValueDecoder(c)
        if c.use_tcpgen:
            self.tcpgen = TCPGen(c.d_model, c.value_vocab_size,
                                 c.gcn_layers, tree_encoder=c.tree_encoder,
                                 dtype=self.dtype)

    def classify(self, memory, memory_mask):
        """[B, T, D] -> (slot presence logits [B, n_slots], slot contexts
        [B, n_slots, D])."""
        c = self.cfg
        q = self.slot_query.weight.to(self.dtype)[None].expand(
            memory.shape[0], c.n_slots, c.d_model)
        bias = attention_bias(memory_mask[:, None, None, :])
        ctx = self.slot_attn(q, memory.to(self.dtype), bias)
        return self.classifier(ctx)[..., 0], ctx

    def _rows(self, memory, memory_mask):
        """The memory and its mask repeated per slot, and each row's slot."""
        n_slots = self.cfg.n_slots
        slot_ids = torch.arange(n_slots, device=memory.device).repeat(
            memory.shape[0])
        return (memory.repeat_interleave(n_slots, 0),
                memory_mask.repeat_interleave(n_slots, 0), slot_ids)

    def tree_encs(self, trie: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Every forest node encoded from the value embedding of its
        incoming token."""
        return self.tcpgen.encode_tree(self.value_decoder.embed_tokens(
            trie["trie_token"].clamp_min(0)), trie)

    def value_logprobs(self, memory, memory_mask, values, *, trie=None,
                       node=None, p_gen_mask=None):
        """Teacher-forced per-step scores: values [B, n_slots, L] (pad -1)
        -> (log p [N, L, V] fp32, ptr [N, L, V+1] or None, p_gen [N, L] or
        None), N = B * n_slots; the decoder reads [0, v_0 .. v_{L-2}]."""
        b, n_slots, l = values.shape
        n = b * n_slots
        mem_rep, mask_rep, slot_ids = self._rows(memory, memory_mask)
        vals = values.clamp_min(0).reshape(n, l)
        ys_in = F.pad(vals, (1, 0))[:, :l]
        logits, hidden = self.value_decoder(ys_in, slot_ids, mem_rep,
                                            mask_rep)
        if self.cfg.use_tcpgen and trie is not None:
            ptr, kb = self.tcpgen(hidden, node.reshape(n, l), trie,
                                  self.tree_encs(trie))
            p_gen = self.tcpgen.gen_prob(hidden, kb,
                                         p_gen_mask.reshape(n, l))
            return tcpgen_final_logprobs(logits, ptr, p_gen), ptr, p_gen
        return torch.log_softmax(logits.float(), dim=-1), None, None

    def forward(self, memory, memory_mask, slot_present, values,
                value_lengths, *, trie=None, node=None, p_gen_mask=None):
        """Training forward -> (loss, stats).

        slot_present: [B, n_slots] 0/1 targets; values: [B, n_slots, L]
        teacher-forced value token ids (pad -1); value_lengths [B,
        n_slots]; trie / node / p_gen_mask: the ontology forest and each
        position's walk from its slot root (walk_forest)."""
        c = self.cfg
        b, n_slots, l = values.shape
        n = b * n_slots
        logits_cls = self.classify(memory, memory_mask)[0].float()
        cls_tgt = slot_present.float()
        bce = (logits_cls.clamp_min(0) - logits_cls * cls_tgt
               + torch.log1p(torch.exp(-logits_cls.abs())))
        loss_cls = bce.mean()

        logp, ptr, p_gen = self.value_logprobs(
            memory, memory_mask, values, trie=trie, node=node,
            p_gen_mask=p_gen_mask)
        tgt = values.reshape(n, l).long()
        pos = torch.arange(l, device=tgt.device)
        valid = ((tgt >= 0) & (pos[None, :]
                               < value_lengths.reshape(n)[:, None])
                 & (slot_present.reshape(n)[:, None] > 0))
        tgt0 = tgt.clamp_min(0)
        nll = -logp.gather(-1, tgt0[..., None])[..., 0]
        denom = valid.sum().clamp_min(1)
        loss_gen = torch.where(valid, nll, torch.zeros_like(nll)).sum() \
            / denom
        loss = loss_cls + loss_gen
        acc = ((logp.argmax(-1) == tgt) & valid).sum() / denom
        stats = {"loss_slot_cls": loss_cls, "loss_slot_gen": loss_gen,
                 "slot_acc": acc}
        if ptr is not None:
            # Oracle pointer CE + open-gate BCE on the live walk steps
            # (p_gen_mask 0: walk_forest is inside the slot's tree).
            live = ((p_gen_mask.reshape(n, l) == 0) & valid).float()
            nlive = live.sum().clamp_min(1.0)
            p_child = ptr[..., :c.value_vocab_size].gather(
                -1, tgt0[..., None])[..., 0]
            loss_ptr = (-torch.log(p_child + 1e-9) * live).sum() / nlive
            loss_gate = (-torch.log(p_gen + 1e-6) * live).sum() / nlive
            loss = loss + c.ptr_loss_weight * loss_ptr \
                + c.gate_loss_weight * loss_gate
            stats["loss_ptr"] = loss_ptr
            stats["loss_gate"] = loss_gate
            stats["p_gen_live"] = (p_gen * live).sum() / nlive
        stats["loss"] = loss
        return loss, stats

    @torch.no_grad()
    def generate(self, memory, memory_mask, *, trie=None, roots=None,
                 boundary_mask=None, dead=None, threshold: float = 0.0):
        """Greedy per-slot value generation -> (slot_logits [B, n_slots],
        values [B, n_slots, max_value_len] long). Slots with logit <=
        ``threshold`` should be ignored by the caller. With a trie, each
        row's walk starts at, and resets to, its slot's root (``roots``
        [n_slots]), as walk_forest walks in training."""
        c = self.cfg
        b = memory.shape[0]
        n = b * c.n_slots
        l = c.max_value_len
        dev = memory.device
        slot_logits, _ = self.classify(memory, memory_mask)
        mem_rep, mask_rep, slot_ids = self._rows(memory, memory_mask)
        use_ptr = c.use_tcpgen and trie is not None
        if use_ptr:
            tree_encs = self.tree_encs(trie)
            row_roots = torch.as_tensor(roots, device=dev).long().repeat(b)
            node = row_roots
            pmask = torch.zeros(n, dtype=torch.long, device=dev)
        ys = torch.zeros(n, l + 1, dtype=torch.long, device=dev)
        for t in range(l):  # max_value_len is small: recompute every step
            logits, hidden = self.value_decoder(ys[:, :l], slot_ids,
                                                mem_rep, mask_rep)
            if use_ptr:
                ptr, kb = self.tcpgen(hidden[:, t], node, trie, tree_encs)
                p_gen = self.tcpgen.gen_prob(hidden[:, t], kb, pmask)
                logp = tcpgen_final_logprobs(logits[:, t], ptr, p_gen)
            else:
                logp = torch.log_softmax(logits[:, t].float(), dim=-1)
            y = logp.argmax(-1)
            ys[:, t + 1] = y
            if use_ptr:
                node, pmask = trie_step(trie, node, y, boundary_mask, -1,
                                        dead, root=row_roots)
        return slot_logits, ys[:, 1:].reshape(b, c.n_slots, l)


def walk_forest(trie: FlatTrie, roots: np.ndarray, prev_tokens: np.ndarray,
                slot_index: np.ndarray, eos_id: int = -1
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Teacher-forced walk from each row's slot root: prev_tokens [N, L],
    slot_index [N] -> (node [N, L], p_gen_mask [N, L]) int32. As
    slu/kb.py:walk_trie, but the reset target is the slot root; mask 1
    where the walk left the tree (the pointer is off)."""
    n, l = prev_tokens.shape
    node = np.zeros((n, l), np.int32)
    mask = np.zeros((n, l), np.int32)
    for i in range(n):
        root = int(roots[slot_index[i]])
        cur = root
        for j in range(l):
            y = int(prev_tokens[i, j])
            row = trie.children_tok[cur, :trie.n_children[cur]]
            hit = np.nonzero(row == y)[0]
            child = (int(trie.children_node[cur, hit[0]])
                     if hit.size else None)
            if j == 0 or y == eos_id:
                cur, m = root, 0
            elif child is not None:
                cur, m = child, 0
            else:
                cur, m = trie.dead, 1
            node[i, j] = cur
            mask[i, j] = m
    return node, mask
