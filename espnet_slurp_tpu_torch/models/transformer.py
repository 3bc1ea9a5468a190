"""Transformer decoder with an explicit KV cache for incremental decoding,
and the abs-pos Transformer encoder.

Port of espnet_slurp_tpu/models/transformer.py (CachedAttention, the relu
FeedForward, DecoderLayer and TransformerDecoder, with the self-attention
or a lightweight / dynamic conv (models/lightconv.py) by
``selfattn_type``, and TransformerEncoder; the
encoder has no kernel of its own: its attention is the eager
models/attention.py:MultiHeadAttention, as the reference's has no Pallas
call). The cache is a dict of
fixed-shape [B, Lmax, H, Dh] tensors per layer. Unlike the reference's pure
functions, ``step`` writes the new key/value row into the cache tensors in
place (and returns them), which saves a copy of every layer's cache per step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attention_bias, causal_mask, length_mask
from .attention import MultiHeadAttention
from .conformer import LN_EPS
from .embedding import (Conv2dSubsampling, abs_positional_encoding,
                        sinusoid_table)
from .layers import LayerNorm, Linear
from .lightconv import LightweightConvolution


class CachedAttention(nn.Module):
    """MHA whose K/V projections can be computed once and cached; the keys
    and values are projected from ``kv_dim``-wide inputs (default
    ``n_feat``: a cross-attention over a wider encoder's states sets
    it)."""

    def __init__(self, n_head: int, n_feat: int, kv_dim: int = 0):
        super().__init__()
        self.n_head, self.n_feat = n_head, n_feat
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(kv_dim or n_feat, n_feat)
        self.linear_v = Linear(kv_dim or n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def _split(self, x):
        return x.reshape(*x.shape[:-1], self.n_head, self.n_feat // self.n_head)

    def project_kv(self, kv_in):
        """[B, Tk, D] -> (k, v), each [B, Tk, H, Dh]."""
        return self._split(self.linear_k(kv_in)), self._split(
            self.linear_v(kv_in))

    def attend(self, q_in, k, v, mask_bias=None):
        """q_in [B, Tq, D]; k, v [B, Tk, H, Dh] -> [B, Tq, D]."""
        dh = self.n_feat // self.n_head
        q = self._split(self.linear_q(q_in))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(dh)
        if mask_bias is not None:
            scores = scores + mask_bias
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.linear_out(out.reshape(*q_in.shape[:-1], self.n_feat))

    def forward(self, q_in, kv_in, mask_bias=None):
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, mask_bias)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w1 = Linear(d_model, d_ff)
        self.w2 = Linear(d_ff, d_model)

    def forward(self, x):
        return self.w2(F.relu(self.w1(x)))


# The decoder's self-attention replacements (models/lightconv.py), by
# ``selfattn_type``: (two_dim, dynamic).
CONV_SELFATTN = {"lightconv": (False, False), "lightconv2d": (True, False),
                 "dynamicconv": (False, True), "dynamicconv2d": (True, True)}


class DecoderLayer(nn.Module):
    """Pre-norm self-attention (or, with ``selfattn_type`` other than
    "selfattn", the causal lightweight / dynamic conv of CONV_SELFATTN),
    cross-attention (over ``memory_dim``-wide states, default d_model) and
    relu FFN."""

    def __init__(self, d_model: int, n_head: int, d_ff: int,
                 selfattn_type: str = "selfattn", conv_wshare: int = 4,
                 conv_kernel: int = 11, conv_usebias: bool = False,
                 memory_dim: int = 0):
        super().__init__()
        self.selfattn_type = selfattn_type
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        if selfattn_type == "selfattn":
            self.self_attn = CachedAttention(n_head, d_model)
        else:
            two_dim, dynamic = CONV_SELFATTN[selfattn_type]
            self.self_attn = LightweightConvolution(
                conv_wshare, d_model, conv_kernel, use_bias=conv_usebias,
                two_dim=two_dim, dynamic=dynamic)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS)
        self.src_attn = CachedAttention(n_head, d_model, memory_dim)
        self.norm3 = LayerNorm(d_model, eps=LN_EPS)
        self.ff = FeedForward(d_model, d_ff)

    def forward(self, x, self_bias, memory, mem_bias):
        h = self.norm1(x)
        if self.selfattn_type == "selfattn":
            x = x + self.self_attn(h, h, self_bias)
        else:
            # the causal conv is the autoregressive mask; padded tails
            # reach only padded rows
            x = x + self.self_attn(h)
        k, v = self.src_attn.project_kv(memory)
        x = x + self.src_attn.attend(self.norm2(x), k, v, mem_bias)
        return x + self.ff(self.norm3(x))

    def step(self, x_t, cache_k, cache_v, step_idx: int, self_bias, mem_k,
             mem_v, mem_bias):
        """One decode step; x_t [B, 1, D]. Writes row ``step_idx`` of
        cache_k/cache_v [B, Lmax, H, Dh] in place (a conv layer: its GLU
        ring in cache_k, cache_v unused). Returns (y_t, cache_k,
        cache_v)."""
        h = self.norm1(x_t)
        if self.selfattn_type == "selfattn":
            k_t, v_t = self.self_attn.project_kv(h)
            cache_k[:, step_idx] = k_t[:, 0]
            cache_v[:, step_idx] = v_t[:, 0]
            x_t = x_t + self.self_attn.attend(h, cache_k, cache_v, self_bias)
        else:
            y, cache_k = self.self_attn.step(h, cache_k, step_idx)
            x_t = x_t + y
        x_t = x_t + self.src_attn.attend(self.norm2(x_t), mem_k, mem_v,
                                         mem_bias)
        return x_t + self.ff(self.norm3(x_t)), cache_k, cache_v


class TransformerDecoder(nn.Module):
    """Pre-norm Transformer decoder with an embedding + abs-PE input.
    Parameters stay fp32; ``dtype`` is the compute dtype (the embedding's
    output and the KV cache). ``selfattn_type`` "selfattn" or one of
    CONV_SELFATTN replaces every layer's self-attention; ``memory_dim`` is
    the width of the encoder states it attends to (default d_model)."""

    def __init__(self, vocab_size: int, d_model: int = 256, n_head: int = 4,
                 d_ff: int = 2048, num_blocks: int = 6,
                 dtype: torch.dtype = torch.float32,
                 selfattn_type: str = "selfattn", conv_wshare: int = 4,
                 conv_kernel: int = 11, conv_usebias: bool = False,
                 memory_dim: int = 0):
        super().__init__()
        self.vocab_size, self.d_model, self.n_head = vocab_size, d_model, n_head
        self.num_blocks, self.dtype = num_blocks, dtype
        self.selfattn_type = selfattn_type
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, n_head, d_ff, selfattn_type, conv_wshare,
                conv_kernel, conv_usebias, memory_dim))
        self.after_norm = LayerNorm(d_model, eps=LN_EPS)
        self.output = Linear(d_model, vocab_size)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_blocks)]

    def forward(self, ys, ys_lengths, memory, memory_lengths,
                memory_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False, causal: bool = True):
        """Scoring forward: [B, L] ids -> [B, L, V] logits; with
        ``return_hidden`` also the pre-output hidden [B, L, D] (TCPGen's
        query). ``causal=False`` lets every position see the whole
        sequence (MaskCTC's bidirectional MLM decoder)."""
        l = ys.shape[1]
        x = abs_positional_encoding(self.embed(ys).to(self.dtype), scale=True)
        self_mask = length_mask(ys_lengths, l)[:, None, None, :]
        if causal:
            self_mask = self_mask & causal_mask(l, ys.device)[None, None]
        self_bias = attention_bias(self_mask)
        if memory_mask is None:
            memory_mask = length_mask(memory_lengths, memory.shape[1])
        mem_bias = attention_bias(memory_mask[:, None, None, :])
        for layer in self.layers:
            x = layer(x, self_bias, memory, mem_bias)
        hidden = self.after_norm(x)
        if return_hidden:
            return self.output(hidden), hidden
        return self.output(hidden)

    # ---- incremental decoding -------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   device=None) -> Dict[str, Dict[str, torch.Tensor]]:
        dh = self.d_model // self.n_head
        dtype = self.dtype
        device = device or self.output.weight.device
        if self.selfattn_type != "selfattn":
            # a GLU ring per layer; "v" an empty placeholder, so the cache
            # keeps the self-attention layout
            return {f"layer_{i}": {
                "k": layer.self_attn.init_cache(batch, max_len, dtype, device),
                "v": torch.zeros(batch, 0, dtype=dtype, device=device)}
                for i, layer in enumerate(self.layers)}
        z = lambda: torch.zeros(batch, max_len, self.n_head, dh, dtype=dtype,
                                device=device)
        return {f"layer_{i}": {"k": z(), "v": z()}
                for i in range(self.num_blocks)}

    def precompute_memory(self, memory):
        """Per-layer cross-attention K/V of the encoder output, once."""
        return {f"layer_{i}": dict(zip(("k", "v"),
                                       layer.src_attn.project_kv(memory)))
                for i, layer in enumerate(self.layers)}

    def step(self, y_t, step_idx: int, cache, mem_kv, memory_lengths,
             max_len: int, memory_mask: Optional[torch.Tensor] = None,
             return_hidden: bool = False):
        """One step: y_t [B] token ids at position ``step_idx``.

        Returns ([B, V] logits, cache) with the cache updated in place, and
        with ``return_hidden`` the pre-output hidden [B, D] third."""
        emb = self.embed(y_t[:, None]).to(self.dtype) * math.sqrt(self.d_model)
        pe = sinusoid_table(1, self.d_model, offset=step_idx)
        emb = emb + torch.from_numpy(pe).to(emb.device, emb.dtype)
        pos = torch.arange(max_len, device=y_t.device)
        self_bias = torch.where(pos <= step_idx, 0.0, -1e9).to(
            torch.float32)[None, None, None, :]
        if memory_mask is None:
            memory_mask = length_mask(memory_lengths,
                                      mem_kv["layer_0"]["k"].shape[1])
        mem_bias = attention_bias(memory_mask[:, None, None, :])
        x = emb
        for i, layer in enumerate(self.layers):
            c, m = cache[f"layer_{i}"], mem_kv[f"layer_{i}"]
            x, c["k"], c["v"] = layer.step(x, c["k"], c["v"], step_idx,
                                           self_bias, m["k"], m["v"], mem_bias)
        hidden = self.after_norm(x)[:, 0]
        if return_hidden:
            return self.output(hidden), cache, hidden
        return self.output(hidden), cache


class TransformerEncoder(nn.Module):
    """Conv2d x4 subsampling, absolute sinusoidal positions, N pre-norm
    blocks (MHSA, relu FFN), after_norm; ``dropout_rate`` on the attention
    probabilities when ``train``, as the reference's. forward: (feats [B,
    T, idim], feat_lengths) -> (hs [B, T', D] with padded frames zeroed,
    h_lengths, []): no interCTC taps, as the reference's."""

    def __init__(self, idim: int, d_model: int = 256, n_head: int = 4,
                 d_ff: int = 2048, num_blocks: int = 12,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_blocks = num_blocks
        self.embed = Conv2dSubsampling(idim, d_model)
        for i in range(num_blocks):
            self.add_module(f"norm1_{i}", LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"self_attn_{i}", MultiHeadAttention(
                n_head, d_model, dropout_rate))
            self.add_module(f"norm2_{i}", LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"ff1_{i}", Linear(d_model, d_ff))
            self.add_module(f"ff2_{i}", Linear(d_ff, d_model))
        self.after_norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = abs_positional_encoding(self.embed(feats), scale=True)
        olens = Conv2dSubsampling.out_length(feat_lengths)
        pad = length_mask(olens, x.shape[1])
        bias = attention_bias(pad[:, None, None, :])
        for i in range(self.num_blocks):
            m = lambda name: getattr(self, f"{name}_{i}")
            h = m("norm1")(x)
            x = x + m("self_attn")(h, h, h, bias, train, generator)
            x = x + m("ff2")(F.relu(m("ff1")(m("norm2")(x))))
        x = self.after_norm(x)
        return torch.where(pad[..., None], x, torch.zeros_like(x)), olens, []
