"""Layers that keep fp32 parameters and compute in their input's dtype.

The flax modules of the reference keep float32 parameters (``param_dtype``)
and compute in ``dtype``: a bf16 model casts each weight to bf16 where it is
used, and Adam updates fp32 master weights. These subclasses do the same:
the parameters stay as they were built (fp32), and each call casts them to
the input's dtype. ``LayerNorm`` matches flax's: statistics in fp32, output
in the input's dtype. The state_dict keys are torch's own.

``dropout`` is the eager dropout that the attention and FFN modules share
on the routes that do not run a kernel (flax's nn.Dropout). ``LSTMLayer``
is flax's ``nn.OptimizedLSTMCell`` run over time (the transducer's
prediction network, the LSTM LM, the RNN encoders and the LAS decoder).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            _cast(self.weight, torch.float32),
                            _cast(self.bias, torch.float32),
                            self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x / (1 - rate) where a uniform draw from ``generator`` (on the
    generator's device, else on x's) is at least ``rate``, else 0, as
    flax's nn.Dropout; x itself at rate 0. A CPU generator draws the same
    mask for a card tensor as for a CPU one (copied over). Autograd keeps
    the mask for the backward."""
    if rate <= 0.0:
        return x
    where = x.device if generator is None else generator.device
    keep = (torch.rand(x.shape, generator=generator, device=where)
            >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LSTMLayer(nn.Module):
    """One layer of flax's ``nn.OptimizedLSTMCell`` over time:
    z = W_ih x + W_hh h + b_hh (no input-side bias), gates i, f, g, o in
    that order; c' = f c + i g, h' = o tanh(c'). The products run in the
    input's dtype, c and h in fp32."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        bound = hidden ** -0.5
        self.weight_ih = nn.Parameter(
            torch.empty(4 * hidden, in_dim).uniform_(-bound, bound))
        self.weight_hh = nn.Parameter(
            torch.empty(4 * hidden, hidden).uniform_(-bound, bound))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """W_ih x for every step at once, in x's dtype."""
        return F.linear(x, self.weight_ih.to(x.dtype))

    def cell(self, xp: torch.Tensor, carry: Tuple[torch.Tensor, torch.Tensor]):
        """One step from the projected input xp [B, 4P]: -> (c', h')."""
        c, h = carry
        dt = xp.dtype
        z = xp + F.linear(h.to(dt), self.weight_hh.to(dt), self.bias_hh.to(dt))
        s = torch.sigmoid(z)
        p = self.hidden
        i, f, o = s[..., :p], s[..., p:2 * p], s[..., 3 * p:]
        g = torch.tanh(z[..., 2 * p:3 * p])
        c = f.float() * c + (i * g).float()
        return c, o.float() * torch.tanh(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, in] -> [B, L, P] (fp32), from a zero carry."""
        xp = self.project(x)
        b = x.shape[0]
        zero = torch.zeros(b, self.hidden, device=x.device)
        carry, outs = (zero, zero), []
        for t in range(x.shape[1]):
            carry = self.cell(xp[:, t], carry)
            outs.append(carry[1])
        return torch.stack(outs, 1)
