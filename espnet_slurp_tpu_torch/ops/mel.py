"""Mel filterbank (Slaney or HTK, librosa-compatible) and log-mel.

Port of espnet_slurp_tpu/ops/mel.py: the filterbank is built host-side in
numpy (this package's own copy) and applied as one matmul.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .masks import length_mask


def _hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(fs: int = 16000, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False) -> np.ndarray:
    """(n_bins, n_mels) triangular filterbank, Slaney area-normalised."""
    if fmax is None:
        fmax = fs / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin), htk),
                          _hz_to_mel(np.array(fmax), htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]
    return weights.T.astype(np.float32)


def logmel(power_spec: torch.Tensor, ilens: torch.Tensor | None = None,
           fs: int = 16000, n_fft: int = 512, n_mels: int = 80,
           fmin: float = 0.0, fmax: float | None = None,
           htk: bool = False) -> torch.Tensor:
    """[B, T, n_bins] power -> [B, T, n_mels] natural-log mel, clamped at
    1e-10; frames past ``ilens`` are zeroed."""
    mat = torch.from_numpy(mel_filterbank(fs, n_fft, n_mels, fmin, fmax,
                                          htk)).to(power_spec.device)
    out = torch.log(torch.clamp(power_spec @ mat, min=1e-10))
    if ilens is not None:
        mask = length_mask(ilens, out.shape[-2])
        out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out
