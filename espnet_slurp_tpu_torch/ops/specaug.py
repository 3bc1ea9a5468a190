"""SpecAugment: time warp, frequency masks, time masks.

Port of espnet_slurp_tpu/ops/specaug.py, the same draw laws and the same
piecewise-linear warp. The reference draws from a jax PRNG key; here every
draw comes from an explicit ``torch.Generator`` on the features' device, so
the two sides give different random numbers from one seed. The drawing and
the applying are separate functions (``draw_*`` / ``time_warp``,
``mask_bands``), so the tests feed both sides the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .masks import length_mask


@dataclasses.dataclass(frozen=True)
class SpecAugConfig:
    apply_time_warp: bool = True
    time_warp_window: int = 5
    apply_freq_mask: bool = True
    freq_mask_width_range: Tuple[int, int] = (0, 20)
    num_freq_mask: int = 2
    apply_time_mask: bool = True
    time_mask_width_range: Tuple[int, int] = (0, 40)
    num_time_mask: int = 2


def draw_bands(gen: torch.Generator, b: int, axis_len: int,
               width_range: Tuple[int, int], num_mask: int):
    """(starts, widths), each int64 [B, num_mask]: width ~ U[w0, w1) and
    start = floor(u * max(1, L - max drawn width)), u ~ U[0, 1)."""
    dev = gen.device
    widths = torch.randint(width_range[0], max(width_range[1], 1),
                           (b, num_mask), generator=gen, device=dev)
    bound = (axis_len - widths.amax()).clamp_min(1).float()  # no host sync
    u = torch.rand(b, num_mask, generator=gen, device=dev)
    return torch.floor(u * bound).long(), widths


def mask_bands(x: torch.Tensor, starts: torch.Tensor, widths: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Zeros the bands [start, start + width) along ``axis`` (1 = time,
    2 = frequency) of x [B, T, F]."""
    pos = torch.arange(x.shape[axis], device=x.device)
    band = (pos[None, None, :] >= starts[..., None]) \
        & (pos[None, None, :] < (starts + widths)[..., None])
    masked = band.any(dim=1)  # [B, L]
    shape = [x.shape[0], 1, 1]
    shape[axis] = x.shape[axis]
    return torch.where(masked.reshape(shape), torch.zeros_like(x), x)


def draw_time_warp(gen: torch.Generator, lengths: torch.Tensor, t: int,
                   window: int):
    """(centers, offsets), int64 [B]: center ~ U[w, max(T - w, w + 1))
    clipped to max(length - w - 1, w); offset ~ U[-w, w]."""
    b, dev = lengths.shape[0], gen.device
    centers = torch.randint(window, max(t - window, window + 1), (b,),
                            generator=gen, device=dev)
    centers = torch.minimum(centers, (lengths.to(dev).long() - window - 1)
                            .clamp_min(window))
    offsets = torch.randint(-window, window + 1, (b,), generator=gen,
                            device=dev)
    return centers, offsets


def time_warp(x: torch.Tensor, centers: torch.Tensor, offsets: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear warp of x [B, T, F] mapping source frame ``center``
    to ``center + offset`` inside each row's valid frames (linear
    interpolation between the two nearest source frames)."""
    t = x.shape[1]
    dst = torch.arange(t, dtype=torch.float32, device=x.device)[None, :]
    c = centers.float()[:, None]
    wc = c + offsets.float()[:, None]
    vl = lengths.float().to(x.device)[:, None]
    left = dst * c / wc.clamp_min(1.0)
    right = c + (dst - wc) * (vl - c) / (vl - wc).clamp_min(1.0)
    src = torch.where(dst < wc, left, right)
    src = torch.minimum(src.clamp_min(0.0), vl - 1.0)
    src = torch.where(dst < vl, src, dst)
    lo = torch.floor(src).long()
    hi = (lo + 1).clamp_max(t - 1)
    frac = (src - lo.float())[..., None]
    gather = lambda idx: x.gather(1, idx[..., None].expand(-1, -1,
                                                           x.shape[2]))
    return gather(lo) * (1.0 - frac) + gather(hi) * frac


def specaug(x: torch.Tensor, lengths: torch.Tensor, cfg: SpecAugConfig,
            gen: torch.Generator) -> torch.Tensor:
    """[B, T, F] features -> augmented features (same shape); every draw
    from ``gen``."""
    b, t, f = x.shape
    if cfg.apply_time_warp and t > 2 * cfg.time_warp_window:
        centers, offsets = draw_time_warp(gen, lengths, t,
                                          cfg.time_warp_window)
        x = time_warp(x, centers, offsets, lengths)
    if cfg.apply_freq_mask:
        x = mask_bands(x, *draw_bands(gen, b, f, cfg.freq_mask_width_range,
                                      cfg.num_freq_mask), axis=2)
    if cfg.apply_time_mask:
        x = mask_bands(x, *draw_bands(gen, b, t, cfg.time_mask_width_range,
                                      cfg.num_time_mask), axis=1)
        x = torch.where(length_mask(lengths.to(x.device), t)[..., None], x,
                        torch.zeros_like(x))
    return x
