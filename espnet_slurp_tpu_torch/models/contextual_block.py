"""Contextual-block streaming Conformer encoder. Port of
espnet_slurp_tpu/models/contextual_block.py.

The subsampled frames are gathered once into [B, NB, L + 2, D] blocks (L =
``block_size``; block b covers original frames b * hop - left ... b * hop
- left + L - 1, left = block_size - hop_size - look_ahead) framed by two
context tokens: the previous block's context and the block's own, which
starts as the masked mean of its frames. Every layer is one batched
Conformer block over the B * NB block sequences; between layers the
context each block emits reaches the next block (a shift by one block),
and the output keeps each block's central ``hop_size`` frames.

The token mask has holes: the frames before original frame 0 in the first
block, and those past each utterance's length just before the trailing
context token. Kernel K3 takes key lengths (and chunks) only, which cannot
state that mask, so the blocks' attention and conv module always take the
eager paths with the mask's additive bias and pad mask (the blocks are
called without ``lengths``, which is what routes models/attention.py and
models/conformer.py:ConvModule eagerly); the FFN halves go through kernel
K2 with ``flash`` "auto" / "on", as in the Conformer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attention_bias, length_mask
from .conformer import ConformerBlock
from .embedding import Conv2dSubsampling, rel_positional_embedding


def _shift_blocks(ctx: torch.Tensor) -> torch.Tensor:
    """[B, NB, D] -> the previous block's context, zeros for block 0."""
    return F.pad(ctx, (0, 0, 1, 0))[:, :-1]


class ContextualBlockConformerEncoder(nn.Module):
    """Conv2d x4 subsampling + N Conformer blocks over contextual blocks:
    forward(feats [B, T, idim], feat_lengths, train, generator) -> (hs [B,
    T', D] with padded frames zeroed, h_lengths, []). ``block_size``,
    ``hop_size`` and ``look_ahead`` are in subsampled frames."""

    def __init__(self, idim: int, d_model: int = 256, n_head: int = 4,
                 d_ff: int = 2048, num_blocks: int = 12,
                 kernel_size: int = 31, dropout_rate: float = 0.0,
                 block_size: int = 40, hop_size: int = 16,
                 look_ahead: int = 16, flash: str = "auto"):
        super().__init__()
        if flash not in ("auto", "on", "off"):
            raise ValueError(f"flash must be auto|on|off, got {flash!r}")
        self.left = block_size - hop_size - look_ahead
        if self.left < 0:
            raise ValueError("block_size must cover hop_size + look_ahead")
        self.d_model, self.num_blocks = d_model, num_blocks
        self.block_size, self.hop_size = block_size, hop_size
        self.embed = Conv2dSubsampling(idim, d_model)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, n_head, d_ff, kernel_size,
                use_flash=flash != "off", dropout_rate=dropout_rate))

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.embed(feats)
        olens = Conv2dSubsampling.out_length(feat_lengths)
        b, t, d = x.shape
        x = x * math.sqrt(self.d_model)
        left, hop, l_blk = self.left, self.hop_size, self.block_size
        nb = -(-t // hop)
        pad_r = max(left + (nb - 1) * hop + l_blk - (t + left), 0)
        xp = F.pad(x, (0, 0, left, pad_r))
        idx = (torch.arange(nb, device=x.device)[:, None] * hop
               + torch.arange(l_blk, device=x.device)[None, :])  # [NB, L]
        orig = idx - left
        valid = (orig >= 0)[None] & (orig[None] < olens[:, None, None])
        blocks = torch.where(valid[..., None], xp[:, idx],
                             torch.zeros((), dtype=x.dtype, device=x.device))
        denom = valid.sum(-1, keepdim=True).clamp_min(1)
        ctx = blocks.sum(2) / denom.to(blocks.dtype)  # [B, NB, D]
        prev_ctx = _shift_blocks(ctx)

        seq_len = l_blk + 2
        pos_emb = rel_positional_embedding(seq_len, d, x.dtype, x.device)
        ones = torch.ones((b, nb, 1), dtype=torch.bool, device=x.device)
        tok_valid = torch.cat([ones, valid, ones], 2).reshape(b * nb, seq_len)
        bias = attention_bias(tok_valid[:, None, None, :])
        frames = blocks
        for i in range(self.num_blocks):
            tok = torch.cat([prev_ctx[:, :, None], frames, ctx[:, :, None]],
                            2).reshape(b * nb, seq_len, d)
            y = getattr(self, f"block_{i}")(tok, pos_emb, bias, tok_valid,
                                            None, train, generator)
            y = y.reshape(b, nb, seq_len, d)
            frames, ctx = y[:, :, 1:-1], y[:, :, -1]
            prev_ctx = _shift_blocks(ctx)
        kept = frames[:, :, left:left + hop].reshape(b, nb * hop, d)[:, :t]
        pad = length_mask(olens, t)
        return torch.where(pad[..., None], kept, torch.zeros_like(kept)), \
            olens, []
