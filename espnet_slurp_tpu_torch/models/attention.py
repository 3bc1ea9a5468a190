"""Multi-head attention: absolute and relative-position (Conformer).

Port of espnet_slurp_tpu/models/attention.py. ``RelPosMultiHeadAttention``
has two paths: with ``use_flash`` and ``lengths`` it calls kernel K3
(ops/kernels/flash_attention.py; on the CPU its plain version), which
builds the key-length and chunk masks itself; otherwise the eager path
materialises the scores, applies ``rel_shift`` and adds ``mask_bias``.
With ``train`` both modules drop attention probabilities at
``dropout_rate``, as the reference's: in K3 under a seed drawn from the
generator, on the eager paths after the softmax (models/layers.py:dropout).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.flash_attention import rel_flash_attention
from ..ops.kernels.philox import draw_seed
from .layers import Linear, dropout


class MultiHeadAttention(nn.Module):
    """Abs-pos MHA with optional cross-attention (q from query, k/v from
    key/value)."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_head, self.n_feat = n_head, n_feat
        self.dropout_rate = dropout_rate
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def forward(self, query, key, value, mask_bias=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h, d = self.n_head, self.n_feat
        dh = d // h
        split = lambda x: x.reshape(*x.shape[:-1], h, dh).transpose(-3, -2)
        q = split(self.linear_q(query))
        k = split(self.linear_k(key))
        v = split(self.linear_v(value))
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
        if mask_bias is not None:
            scores = scores + mask_bias
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = dropout(attn, self.dropout_rate if train else 0.0, generator)
        out = (attn @ v).transpose(-3, -2).reshape(*query.shape[:-1], d)
        return self.linear_out(out)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: [B, H, T, 2T-1] scores against
    positions T-1 ... -(T-1) -> [B, H, T, T], out[..., i, j] =
    x[..., i, (T-1) - i + j]."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, p + 1, t)
    return x[:, :, 1:, :].reshape(b, h, t, p)[:, :, :, :t]


class RelPosMultiHeadAttention(nn.Module):
    """Relative-position MHA with learned per-head biases pos_bias_u/v and
    a bias-free linear_pos over the positional embedding."""

    def __init__(self, n_head: int, n_feat: int, use_flash: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_head, self.n_feat, self.use_flash = n_head, n_feat, use_flash
        self.dropout_rate = dropout_rate
        dh = n_feat // n_head
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, dh))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, dh))
        self.linear_out = Linear(n_feat, n_feat)

    def forward(self, x, pos_emb, mask_bias=None, lengths=None, chunk_size=0,
                left_chunks=-1, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h, d = self.n_head, self.n_feat
        dh = d // h
        b, t, _ = x.shape
        q = self.linear_q(x).reshape(b, t, h, dh)
        k = self.linear_k(x).reshape(b, t, h, dh).transpose(1, 2)
        v = self.linear_v(x).reshape(b, t, h, dh).transpose(1, 2)
        p = self.linear_pos(pos_emb)  # [1, 2T-1, D]
        q_u = (q + self.pos_bias_u.to(q.dtype)).transpose(1, 2)  # [B,H,T,Dh]
        q_v = (q + self.pos_bias_v.to(q.dtype)).transpose(1, 2)
        scale = 1.0 / math.sqrt(dh)
        rate = self.dropout_rate if train else 0.0

        if self.use_flash and lengths is not None:
            # [1, 2T-1, D] -> [H, 2T, Dh]; the trailing zero row keeps the
            # reference kernel's table shape (it is never read).
            p4 = F.pad(p.reshape(2 * t - 1, h, dh).transpose(0, 1),
                       (0, 0, 0, 1))
            out = rel_flash_attention(
                q_u.contiguous(), q_v.contiguous(), k.contiguous(),
                v.contiguous(), p4.contiguous(),
                lengths.to(torch.int32).contiguous(),
                draw_seed(generator, x.device) if rate > 0.0 else None,
                scale=scale, dropout_rate=rate, chunk_size=chunk_size,
                left_chunks=left_chunks)
            return self.linear_out(out.transpose(1, 2).reshape(b, t, d))

        p = p.reshape(p.shape[0], -1, h, dh).transpose(1, 2)  # [1,H,2T-1,Dh]
        ac = q_u.float() @ k.float().transpose(-1, -2)
        bd = rel_shift(q_v.float() @ p.float().transpose(-1, -2))
        scores = (ac + bd) * scale
        if mask_bias is not None:
            scores = scores + mask_bias
        attn = dropout(torch.softmax(scores, dim=-1).to(v.dtype), rate,
                       generator)
        out = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self.linear_out(out)
