"""Length / attention masks. Port of espnet_slurp_tpu/ops/masks.py."""
from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at valid positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def causal_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] bool, True where attention is allowed (lower triangle)."""
    ar = torch.arange(size, device=device)
    return ar[None, :] <= ar[:, None]


def attention_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Bool mask -> additive bias: 0 where allowed, -1e9 where not (finite,
    so a fully masked row is uniform instead of NaN)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e9))


def band_mask(size: int, window: int, device=None) -> torch.Tensor:
    """[size, size] bool sliding-window mask: frame i sees the frames j
    with |i - j| <= window (the longformer encoder's attention_window)."""
    ar = torch.arange(size, device=device)
    return (ar[:, None] - ar[None, :]).abs() <= window


def chunk_mask(size: int, chunk_size: int, left_chunks: int = -1,
               device=None) -> torch.Tensor:
    """[size, size] bool streaming mask: frame i sees its own chunk and up to
    ``left_chunks`` previous chunks (-1 = all)."""
    c = torch.arange(size, device=device) // chunk_size
    row, col = c[:, None], c[None, :]
    ok = col <= row
    if left_chunks >= 0:
        ok = ok & (col >= row - left_chunks)
    return ok
