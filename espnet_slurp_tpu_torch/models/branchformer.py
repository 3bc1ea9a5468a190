"""E-Branchformer encoder. Port of espnet_slurp_tpu/models/branchformer.py
(``CgMLP``, ``EBranchformerBlock``, ``EBranchformerEncoder``).

Each block: a macaron FFN half, then two branches on the same input (rel-pos
self-attention, and the convolutional gating MLP: channel projection, tanh
GELU, split, the gate half LayerNorm'd, pad-masked and depthwise-convolved,
the product projected back), merged by a depthwise conv over their concat
plus a linear, then the second FFN half and ``norm_final``.

The reference builds its attention and FFNs eagerly. Here, with ``flash``
"auto" / "on", the FFN halves go through kernel K2 (where it takes the
widths: ``conformer.FeedForward``) and the attention through kernel K3 with
the key lengths and the optional chunk mask, which is the whole of the
reference's mask (K3 gives padded query rows the eager mask's key set, so
padded rows come out as the reference's); "off" runs both eagerly with the
additive bias. The merge conv and the cgMLP's ``a`` half are not
pad-masked in the reference, so padded frames feed the last valid ones
through them, as there. Dropout (``dropout_rate`` when ``train``) acts on
the FFN hiddens and attention probabilities, drawn from the generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attention_bias, chunk_mask, length_mask
from .attention import RelPosMultiHeadAttention
from .conformer import LN_EPS, FeedForward
from .embedding import Conv2dSubsampling, rel_positional_embedding
from .layers import Conv1d, LayerNorm, Linear


def same_depthwise(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """flax "SAME" depthwise conv over time: [B, T, C] -> [B, T, C], (k-1)//2
    frames of zeros on the left and the rest on the right."""
    k = conv.kernel_size[0]
    left = (k - 1) // 2
    return conv(F.pad(x.transpose(1, 2), (left, k - 1 - left))).transpose(1, 2)


class CgMLP(nn.Module):
    """Convolutional gating MLP branch."""

    def __init__(self, d_model: int, d_hidden: int, kernel_size: int = 31):
        super().__init__()
        half = d_hidden // 2
        self.channel_proj1 = Linear(d_model, d_hidden)
        self.gate_norm = LayerNorm(half, eps=LN_EPS)
        self.gate_conv = Conv1d(half, half, kernel_size, groups=half)
        self.channel_proj2 = Linear(half, d_model)

    def forward(self, x, pad_mask=None):
        h = F.gelu(self.channel_proj1(x), approximate="tanh")
        a, b = h.chunk(2, dim=-1)
        b = self.gate_norm(b)
        if pad_mask is not None:
            b = torch.where(pad_mask[..., None], b, torch.zeros_like(b))
        return self.channel_proj2(a * same_depthwise(self.gate_conv, b))


class EBranchformerBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_ff: int,
                 cgmlp_hidden: int, kernel_size: int = 31,
                 merge_kernel: int = 3, use_flash: bool = False,
                 chunk_size: int = 0, left_chunks: int = -1,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        ln = lambda: LayerNorm(d_model, eps=LN_EPS)
        self.norm_ff1 = ln()
        self.ff1 = FeedForward(d_model, d_ff, use_flash, dropout_rate)
        self.norm_attn = ln()
        self.self_attn = RelPosMultiHeadAttention(n_head, d_model, use_flash,
                                                  dropout_rate)
        self.norm_mlp = ln()
        self.cgmlp = CgMLP(d_model, cgmlp_hidden, kernel_size)
        self.merge_conv = Conv1d(2 * d_model, 2 * d_model, merge_kernel,
                                 groups=2 * d_model)
        self.merge_proj = Linear(2 * d_model, d_model)
        self.norm_ff2 = ln()
        self.ff2 = FeedForward(d_model, d_ff, use_flash, dropout_rate)
        self.norm_final = ln()

    def forward(self, x, pos_emb, mask_bias, pad_mask, lengths=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x + 0.5 * self.ff1(self.norm_ff1(x), train, generator)
        attn = self.self_attn(
            self.norm_attn(x), pos_emb, mask_bias, lengths=lengths,
            chunk_size=self.chunk_size, left_chunks=self.left_chunks,
            train=train, generator=generator)
        mlp = self.cgmlp(self.norm_mlp(x), pad_mask)
        cat = torch.cat([attn, mlp], dim=-1)
        x = x + self.merge_proj(cat + same_depthwise(self.merge_conv, cat))
        x = x + 0.5 * self.ff2(self.norm_ff2(x), train, generator)
        return self.norm_final(x)


class EBranchformerEncoder(nn.Module):
    """Conv2d x4 subsampling + N E-Branchformer blocks, the
    ConformerEncoder's interface: forward(feats [B, T, idim], feat_lengths,
    train, generator) -> (hs [B, T', D] with padded frames zeroed,
    h_lengths, taps), ``taps`` holding (layer, x) after each block of
    ``interctc_layers`` (the block's output as it is: the encoder has no
    after_norm). ``flash``: "auto" / "on" run the FFNs through K2 and the
    attention through K3; "off" eagerly."""

    def __init__(self, idim: int, d_model: int = 256, n_head: int = 4,
                 d_ff: int = 1024, num_blocks: int = 12,
                 cgmlp_hidden: int = 2048, kernel_size: int = 31,
                 dropout_rate: float = 0.0, interctc_layers=(),
                 chunk_size: int = 0, left_chunks: int = -1,
                 flash: str = "auto"):
        super().__init__()
        if flash not in ("auto", "on", "off"):
            raise ValueError(f"flash must be auto|on|off, got {flash!r}")
        self.d_model, self.num_blocks = d_model, num_blocks
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.use_flash = flash != "off"
        self.interctc_layers = tuple(interctc_layers)
        self.embed = Conv2dSubsampling(idim, d_model)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", EBranchformerBlock(
                d_model, n_head, d_ff, cgmlp_hidden, kernel_size,
                use_flash=self.use_flash, chunk_size=chunk_size,
                left_chunks=left_chunks, dropout_rate=dropout_rate))

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.embed(feats)
        olens = Conv2dSubsampling.out_length(feat_lengths)
        t = x.shape[1]
        x = x * math.sqrt(self.d_model)
        pos_emb = rel_positional_embedding(t, self.d_model, x.dtype, x.device)
        pad = length_mask(olens, t)
        bias = None  # K3 masks the key lengths and chunks itself
        if not self.use_flash:
            att_mask = pad[:, None, None, :]
            if self.chunk_size > 0:
                att_mask = att_mask & chunk_mask(
                    t, self.chunk_size, self.left_chunks, x.device)[None, None]
            bias = attention_bias(att_mask)
        taps = []
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, bias, pad, olens,
                                            train, generator)
            if (i + 1) in self.interctc_layers:
                taps.append((i + 1, x))
        x = torch.where(pad[..., None], x, torch.zeros_like(x))
        return x, olens, taps
