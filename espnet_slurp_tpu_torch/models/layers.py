"""Layers that keep fp32 parameters and compute in their input's dtype.

The flax modules of the reference keep float32 parameters (``param_dtype``)
and compute in ``dtype``: a bf16 model casts each weight to bf16 where it is
used, and Adam updates fp32 master weights. These subclasses do the same:
the parameters stay as they were built (fp32), and each call casts them to
the input's dtype. ``LayerNorm`` matches flax's: statistics in fp32, output
in the input's dtype. The state_dict keys are torch's own.

``dropout`` is the eager dropout that the attention and FFN modules share
on the routes that do not run a kernel (flax's nn.Dropout).
"""
from __future__ import annotations

from typing import Optional

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
    """x / (1 - rate) where a uniform draw from ``generator`` (on x's
    device) is at least ``rate``, else 0, as flax's nn.Dropout; x itself at
    rate 0. Autograd keeps the mask for the backward."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
