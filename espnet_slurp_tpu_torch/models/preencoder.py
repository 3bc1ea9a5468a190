"""Pre-encoders: learned Sinc filters over raw frames, and a projection.
Port of espnet_slurp_tpu/models/preencoder.py (``mel_bank``, ``bark_bank``,
``SincConv``, ``LightweightSincConvs``, ``LinearPreencoder``).

``LightweightSincConvs`` takes the sliding-window frontend's raw frames
(ops/frontend.py, ``frontend.type: sliding_window``), every frame one
batch row: SincConv (128 band-pass filters rebuilt each call from their
learned [C, 2] edges) -> log compression -> LayerNorm -> avg-pool 2, a
strided depthwise block with a pool, three depthwise-separable blocks and
a depthwise coupling block (each: conv, leaky ReLU, LayerNorm, dropout
when training: 0.1 in the first, ``dropout_rate`` in the others), groups
gcd(in, out), VALID convs and pools; the output flattened as (width,
channel), channel fastest. The flax modules pass no dtype, so past the
SincConv (which runs in the input's dtype) they compute in fp32, and so do
these; the encoder takes their output in the model's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conformer import LN_EPS
from .layers import Conv1d, LayerNorm, Linear, dropout


def mel_bank(channels: int, fs: float) -> np.ndarray:
    """[C, 2] (f1, f2) band edges, mel-spaced over [30 Hz, fs/2]."""
    def to_mel(f):
        return 1125.0 * np.log(f / 700.0 + 1.0)

    def from_mel(m):
        return 700.0 * (np.exp(m / 1125.0) - 1.0)

    freqs = from_mel(np.linspace(to_mel(30.0), to_mel(fs * 0.5),
                                 channels + 2))
    return np.stack([freqs[:-2], freqs[2:]], axis=1)


def bark_bank(channels: int, fs: float) -> np.ndarray:
    """[C, 2] band edges on the Bark critical-bandwidth scale."""
    def to_bark(f):
        return ((f / 1000.0) ** 2 * 1.4 + 1.0) ** 0.69 * 75.0 + 25.0

    def invert(b):
        f = (b - 25.0) / 75.0
        f = f ** (1.0 / 0.69)
        f = (f - 1.0) / 1.4
        return np.sqrt(np.maximum(f, 0.0)) * 1000.0

    centers = invert(np.linspace(to_bark(70.0), to_bark(fs * 0.45),
                                 channels))
    half_bw = to_bark(centers) / 2.0
    return np.stack([centers - half_bw, centers + half_bw], axis=1)


class SincConv(nn.Module):
    """Learnable band-pass filters over raw samples: [N, D] frames -> [N,
    D_out, C] (VALID, ``stride``). The only parameter is ``f``, the [C, 2]
    band edges over fs; the [C, K] filters are rebuilt from it per call."""

    def __init__(self, out_channels: int, kernel_size: int = 101,
                 stride: int = 1, fs: float = 16000.0,
                 window: str = "hamming", scale: str = "mel"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SincConv kernel must be odd")
        self.kernel_size, self.stride = kernel_size, stride
        self.fs, self.window, self.scale = fs, window, scale
        self.f = nn.Parameter(self.initial_bands(out_channels))

    def initial_bands(self, channels: Optional[int] = None) -> torch.Tensor:
        """The reference's initial ``f``: the scale's bank over fs."""
        c = channels or self.f.shape[0]
        bank = {"mel": mel_bank, "bark": bark_bank}[self.scale]
        return torch.from_numpy(np.asarray(
            bank(c, self.fs) / self.fs, np.float32))

    def filters(self) -> torch.Tensor:
        half = self.kernel_size // 2
        f = self.f.float()
        n = torch.arange(1, half + 1, dtype=torch.float32, device=f.device)
        xn = 2.0 * math.pi * n
        if self.window == "hamming":
            w = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n.flip(0)
                                        / (2 * half + 1))
        else:
            w = torch.ones_like(n)
        f_min = f[:, 0].abs()
        f_max = f_min + (f[:, 1] - f[:, 0]).abs()
        right = (torch.sin(f_max[:, None] * xn)
                 - torch.sin(f_min[:, None] * xn)) / (0.5 * xn) * w
        center = 2.0 * (f_max - f_min)[:, None]
        return torch.cat([right.flip(1), center, right], dim=1)  # [C, K]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.filters().to(x.dtype)[:, None, :]
        return F.conv1d(x[:, None, :], k, stride=self.stride).transpose(1, 2)


class LightweightSincConvs(nn.Module):
    """[B, T, D_win] raw frames -> [B, T, out_channels * D_out]. The blocks'
    modules are named as the flax tree names them ({block}_dw, _pw, _ln)."""

    def __init__(self, out_channels: int = 256, fs: float = 16000.0,
                 window: str = "hamming", scale: str = "mel",
                 dropout_rate: float = 0.15):
        super().__init__()
        self.out_channels = out_channels
        self.sinc = SincConv(128, fs=fs, window=window, scale=scale)
        self.sinc_ln = LayerNorm(128, eps=LN_EPS)
        # (name, in, out, kernel, stride, pointwise, avg-pool, dropout)
        self.blocks = [("dconv1", 128, 128, 25, 2, False, True, 0.1)]
        in_c = 128
        for i in (2, 3, 4):
            self.blocks.append((f"dconv{i}", in_c, out_channels, 9, 1, True,
                                False, dropout_rate))
            in_c = out_channels
        self.blocks.append(("dconv5", in_c, out_channels, 7, 1, False,
                            False, dropout_rate))
        for name, i_c, o_c, k, stride, pointwise, _, _ in self.blocks:
            self.add_module(f"{name}_dw", Conv1d(i_c, o_c, k, stride,
                                                 groups=math.gcd(i_c, o_c)))
            if pointwise:
                self.add_module(f"{name}_pw", Conv1d(o_c, o_c, 1))
            self.add_module(f"{name}_ln", LayerNorm(o_c, eps=LN_EPS))

    @staticmethod
    def out_width(d_win: int) -> int:
        """The width D_out of a D_win-sample frame after every stage."""
        w = (d_win - 100) // 2            # sinc (k 101) + pool
        w = ((w - 25) // 2 + 1) // 2      # dconv1 (k 25, s 2) + pool
        return w - 3 * 8 - 6              # dconv2-4 (k 9), dconv5 (k 7)

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, d = feats.shape
        x = self.sinc(feats.reshape(b * t, d))         # [BT, D', 128]
        x = self.sinc_ln(torch.log(x.abs() + 1.0).float())
        x = F.avg_pool1d(x.transpose(1, 2), 2, 2)      # [BT, 128, W]
        for name, _, _, _, _, pointwise, avgpool, rate in self.blocks:
            m = lambda part: getattr(self, f"{name}_{part}")
            x = m("dw")(x)
            if pointwise:
                x = m("pw")(x)
            x = m("ln")(F.leaky_relu(x, 0.01).transpose(1, 2)).transpose(1, 2)
            if avgpool:
                x = F.avg_pool1d(x, 2, 2)
            x = dropout(x, rate if train else 0.0, generator)
        return x.transpose(1, 2).reshape(b, t, -1)


class LinearPreencoder(nn.Module):
    """A projection to ``output_size``, in fp32 (the flax Dense's promoted
    dtype)."""

    def __init__(self, idim: int, output_size: int = 80):
        super().__init__()
        self.proj = Linear(idim, output_size)

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.proj(feats.float())
