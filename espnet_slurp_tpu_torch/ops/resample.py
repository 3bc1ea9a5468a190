"""Speed perturbation and resampling. Port of espnet_slurp_tpu/ops/resample.py.

``resample_sinc`` and ``speed_perturb`` are host numpy (data preparation,
recipe stage 2), the reference's arithmetic over blocks of output samples;
``resample_linear_device`` is the torch form of its on-device
linear-interpolation resample.
"""
from __future__ import annotations

import numpy as np
import torch


# Output samples resampled at a time: the [rows, 2 num_zeros] float64 tap
# arrays stay in cache. Every output sample is computed as the reference
# computes it, so the result is the same bit for bit.
_SINC_ROWS = 4096


def resample_sinc(x: np.ndarray, factor: float, num_zeros: int = 16
                  ) -> np.ndarray:
    """Resample by ``factor`` (speed: output length = len(x) / factor), by
    windowed-sinc interpolation at fractional positions (the role of sox's
    speed effect)."""
    n_out = int(round(len(x) / factor))
    taps = np.arange(-num_zeros + 1, num_zeros + 1)
    out = np.empty(n_out, x.dtype)
    for start in range(0, n_out, _SINC_ROWS):
        pos = np.arange(start, min(start + _SINC_ROWS, n_out)) * factor
        left = np.floor(pos).astype(np.int64)
        idx = np.clip(left[:, None] + taps[None, :], 0, len(x) - 1)
        k = taps[None, :] - (pos - left)[:, None]
        kern = np.sinc(k) * _hann_window(k, num_zeros)
        out[start:start + len(pos)] = (x[idx] * kern).sum(axis=1)
    return out


def _hann_window(k: np.ndarray, num_zeros: int) -> np.ndarray:
    return 0.5 + 0.5 * np.cos(np.pi * np.clip(k / num_zeros, -1, 1))


def speed_perturb(x: np.ndarray, factor: float) -> np.ndarray:
    """sox speed: a playback-rate change (the pitch shifts too)."""
    if factor == 1.0:
        return x
    return resample_sinc(x, factor)


def resample_linear_device(x: torch.Tensor, factor: float,
                           n_out: int) -> torch.Tensor:
    """Linear-interpolation resample of [..., N] to a fixed output length
    ``n_out``, on x's device."""
    pos = torch.arange(n_out, device=x.device, dtype=torch.float32) * factor
    left = pos.floor().long().clamp(0, x.shape[-1] - 2)
    frac = (pos - left).to(x.dtype)
    return x[..., left] * (1 - frac) + x[..., left + 1] * frac
