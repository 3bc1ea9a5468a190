"""Lightweight and dynamic convolutions (Pay Less Attention). Port of
espnet_slurp_tpu/models/lightconv.py (``LightweightConvolution``), the
self-attention replacements of the lightweight_conv(2d) / dynamic_conv(2d)
Transformer decoders.

linear -> GLU -> a causal depthwise conv over time whose softmax-normalised
kernel is shared by ``wshare`` channel groups (static: a parameter [H, k];
dynamic: predicted per position from the GLU output) -> linear. Each
position sees itself and the k // 2 frames before it: the kernel is cut to
its first k // 2 + 1 taps (oldest to current), as the reference's kernel
mask keeps them. ``two_dim`` adds the 2-D variants' frequency branch: one
[k] kernel (static, or per position when dynamic) slid over the channel
axis, its output concatenated before ``linear2``. The windows are unfolded
into [B, T, window, D] and combined in fp32, nothing quadratic in T.
Incremental decoding keeps a ring of GLU outputs [B, Lmax + k // 2, D]
(the KV cache's place) that ``step`` writes in place and reads one window
of. The reference's non-causal form (``use_kernel_mask=False``) has no
caller in either package and is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class LightweightConvolution(nn.Module):
    def __init__(self, wshare: int, n_feat: int, kernel_size: int = 11,
                 use_bias: bool = False, two_dim: bool = False,
                 dynamic: bool = False):
        super().__init__()
        if n_feat % wshare:
            raise ValueError(f"n_feat {n_feat} is no multiple of wshare "
                             f"{wshare}")
        d, k = n_feat, kernel_size
        self.wshare, self.n_feat, self.kernel_size = wshare, n_feat, k
        self.use_bias, self.two_dim, self.dynamic = use_bias, two_dim, dynamic
        self.window = k // 2 + 1
        self.linear1 = Linear(d, 2 * d)
        self.linear2 = Linear(2 * d if two_dim else d, d)
        if dynamic:
            self.linear_weight = Linear(d, wshare * k)
        else:
            self.weight = nn.Parameter(torch.rand(wshare, k))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(d))
        if two_dim:
            if dynamic:
                self.linear_weight_f = Linear(d, k)
            else:
                self.weight_f = nn.Parameter(torch.rand(k))

    def _glu(self, x):
        a, b = self.linear1(x).chunk(2, dim=-1)
        return a * torch.sigmoid(b)

    def _kernels(self, xg):
        """Softmax kernels over the window's taps: [H, w] (static) or [B,
        T, H, w] (dynamic), fp32."""
        if self.dynamic:
            w = self.linear_weight(xg)
            w = w.reshape(*xg.shape[:-1], self.wshare, self.kernel_size)
        else:
            w = self.weight
        return torch.softmax(w[..., :self.window].float(), dim=-1)

    def _freq_branch(self, xg):
        k = self.kernel_size
        if self.dynamic:
            wf = torch.softmax(self.linear_weight_f(xg).float(), dim=-1)
        else:
            wf = torch.softmax(self.weight_f.float(), dim=-1)
        c = xg.shape[-1]
        xp = F.pad(xg.float(), (k // 2, (k - 1) // 2))
        win = torch.stack([xp[..., i:i + c] for i in range(k)], dim=-2)
        if self.dynamic:
            out = torch.einsum("...kc,...k->...c", win, wf)
        else:
            out = torch.einsum("...kc,k->...c", win, wf)
        return out.to(xg.dtype)

    def _combine(self, win, xg):
        """win [B, T, w, D] (fp32) windows of the GLU outputs xg [B, T, D]
        -> the input of linear2, in xg's dtype."""
        b, t, window, d = win.shape
        h = self.wshare
        win = win.reshape(b, t, window, h, d // h)
        w = self._kernels(xg)
        if self.dynamic:
            out = torch.einsum("btkhd,bthk->bthd", win, w)
        else:
            out = torch.einsum("btkhd,hk->bthd", win, w)
        out = out.reshape(b, t, d).to(xg.dtype)
        if self.use_bias:
            out = out + self.bias.to(out.dtype)
        if self.two_dim:
            out = torch.cat([out, self._freq_branch(xg)], dim=-1)
        return out

    def forward(self, x):
        """[B, T, D] -> [B, T, D]."""
        xg = self._glu(x)
        t = xg.shape[1]
        xp = F.pad(xg, (0, 0, self.window - 1, 0))
        win = torch.stack([xp[:, i:i + t] for i in range(self.window)], 2)
        return self.linear2(self._combine(win.float(), xg))

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        return torch.zeros(batch, max_len + self.window - 1, self.n_feat,
                           dtype=dtype, device=device)

    def step(self, x_t, cache, step_idx: int):
        """x_t [B, 1, D] at position ``step_idx``. Writes the step's GLU
        output into ``cache`` in place -> (y_t [B, 1, D], cache)."""
        xg = self._glu(x_t)
        cache[:, step_idx + self.window - 1] = xg[:, 0].to(cache.dtype)
        win = cache[:, step_idx:step_idx + self.window][:, None].float()
        return self.linear2(self._combine(win, xg)), cache
