"""STFT as framed matmul against a windowed DFT basis.

Port of espnet_slurp_tpu/ops/stft.py (torch.stft semantics: hann window,
center=True reflect padding, onesided). The frames are a strided view
(``unfold``) multiplied by the precomputed real/imag basis in fp32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int, window: str | None) -> np.ndarray:
    """Windowed real-DFT basis, (win_length, 2 * (n_fft//2+1)): real part
    columns first, then imaginary; the window is centred within n_fft."""
    n_bins = n_fft // 2 + 1
    if window == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_length) / win_length)
    elif window is None:
        w = np.ones(win_length)
    else:
        raise ValueError(f"unsupported window: {window}")
    offset = (n_fft - win_length) // 2
    n = offset + np.arange(win_length)
    k = np.arange(n_bins)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    return (w[:, None] * basis).astype(np.float32)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[B, N] -> [B, T, frame_length] frames at stride ``hop`` (a view);
    T = 1 + (N - frame_length) // hop."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int = 512, win_length: int | None = None,
         hop_length: int = 128, window: str | None = "hann",
         center: bool = True) -> torch.Tensor:
    """[B, N] float -> [B, T, n_bins, 2] (real, imag), onesided."""
    if win_length is None:
        win_length = n_fft
    if center:
        pad = n_fft // 2
        x = F.pad(x.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
    off = (n_fft - win_length) // 2
    frames = frame_signal(x, n_fft, hop_length)[..., off:off + win_length]
    basis = torch.from_numpy(_dft_basis(n_fft, win_length, window)).to(
        x.device)
    spec = frames.float() @ basis
    n_bins = n_fft // 2 + 1
    return torch.stack([spec[..., :n_bins], spec[..., n_bins:]], dim=-1)


def stft_out_lengths(ilens: torch.Tensor, n_fft: int = 512, hop: int = 128,
                     center: bool = True) -> torch.Tensor:
    """Per-example valid frame counts for sample lengths ``ilens``."""
    if center:
        return 1 + torch.div(ilens, hop, rounding_mode="floor")
    return 1 + torch.div(ilens - n_fft, hop, rounding_mode="floor")
