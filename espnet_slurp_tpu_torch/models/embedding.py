"""Positional encodings and convolutional subsampling.

Port of espnet_slurp_tpu/models/embedding.py. Layout note: the reference
convolves NHWC (B, T, F, C); here the convs are torch NCHW (B, C, T, F), so
H = time and W = frequency in both, and the output projection stays the
reference's (1, F')-wide conv (weights HWIO -> OIHW, no flatten-order
change).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import Conv2d

# Per-factor (kernel, stride) stacks, VALID padding over (time, freq).
_SUBSAMPLE_SPECS = {
    2: ((3, 2), (3, 1)),
    4: ((3, 2), (3, 2)),
    6: ((3, 2), (5, 3)),
    8: ((3, 2), (3, 2), (3, 2)),
}


def sinusoid_table(length: int, d_model: int, offset: int = 0) -> np.ndarray:
    """Sinusoidal table for positions [offset, offset + length)."""
    pos = np.arange(offset, offset + length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    tbl = np.zeros((length, d_model))
    tbl[:, 0::2] = np.sin(pos * div)
    tbl[:, 1::2] = np.cos(pos * div)
    return tbl.astype(np.float32)


def abs_positional_encoding(x: torch.Tensor, scale: bool = True
                            ) -> torch.Tensor:
    """x * sqrt(D) (if scale) + absolute sinusoids; x: [B, T, D]."""
    t, d = x.shape[-2], x.shape[-1]
    pe = torch.from_numpy(sinusoid_table(t, d)).to(x.device, x.dtype)
    if scale:
        x = x * float(np.sqrt(d))
    return x + pe


def rel_positional_embedding(t: int, d: int, dtype=torch.float32,
                             device=None) -> torch.Tensor:
    """[1, 2T-1, D] sinusoids for relative positions T-1 ... -(T-1)."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(np.log(10000.0) / d))
    tbl = np.zeros((2 * t - 1, d))
    tbl[:, 0::2] = np.sin(pos * div)
    tbl[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(tbl.astype(np.float32)).to(device, dtype)[None]


class Conv2dSubsampling(nn.Module):
    """Stacked conv(k x k, stride s) + ReLU over (time, freq), then the
    (1, F')-wide output conv: [B, T, idim] -> [B, T', odim]. Default x4:
    T' = ((T - 1) // 2 - 1) // 2."""

    def __init__(self, idim: int, odim: int, factor: int = 4):
        super().__init__()
        self.factor = factor
        ch, f = 1, idim
        self.n_convs = len(_SUBSAMPLE_SPECS[factor])
        for i, (k, s) in enumerate(_SUBSAMPLE_SPECS[factor]):
            self.add_module(f"conv{i + 1}", Conv2d(ch, odim, k, s))
            ch, f = odim, (f - k) // s + 1
        self.out = Conv2d(odim, odim, (1, f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.unsqueeze(1)
        for i in range(self.n_convs):
            h = torch.relu(getattr(self, f"conv{i + 1}")(h))
        return self.out(h)[..., 0].transpose(1, 2)

    @staticmethod
    def out_length(ilens: torch.Tensor, factor: int = 4) -> torch.Tensor:
        for k, s in _SUBSAMPLE_SPECS[factor]:
            ilens = torch.div(ilens - k, s, rounding_mode="floor") + 1
        return ilens

    @staticmethod
    def out_length_static(t: int, factor: int = 4) -> int:
        for k, s in _SUBSAMPLE_SPECS[factor]:
            t = (t - k) // s + 1
        return t
