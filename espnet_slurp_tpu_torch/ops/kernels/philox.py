"""Philox4x32-10 dropout keep masks: the plain version of csrc/philox.cuh.

Every launch of K2 (fused FFN) and K3 (rel-pos flash attention) draws its
dropout mask in the kernel from Philox4x32-10, the mask of an element a
pure function of (seed, plane, row, column): K2's (n, f) of the [N, F]
hidden on plane 0, K3's (i, j) of the [T, T] probabilities on plane b * H
+ h. This module computes the same bits with PyTorch integer ops (on int64
tensors holding uint32 values), on CPU and CUDA tensors alike; every plain
version of those kernels takes its mask from ``keep_mask``. The counter
layout and the 16-bit draw are documented in csrc/philox.cuh.

The seed is a one-element int32 tensor on the compute device (the
reference's ``seed_ref``), drawn by ``draw_seed`` from the training
generator. A train step's generator lives on the compute device, so no
side reads the seed on the host; a CPU generator serves another device's
draws too (the seeds are then drawn on the CPU and copied), which gives a
CPU run and a card run the same seeds, hence the same masks.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
DRAW_BITS = 16  # width of one element's draw


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of m * x, x < 2^32, without leaving int64."""
    p1 = (x & 0xFFFF) * m
    p2 = (x >> 16) * m
    return (p2 + (p1 >> 16)) >> 16, (((p2 & 0xFFFF) << 16) + p1) & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 of counter (4 words) under key (2 words); each word an
    int or an int64 tensor of uint32 values, tensors broadcast. Returns the
    4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def threshold(rate: float) -> int:
    """The keep test's threshold: an element is kept when its 16-bit draw
    is at least floor(rate * 2^16)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * (1 << DRAW_BITS))


def keep_probability(rate: float) -> float:
    return 1.0 - threshold(rate) / float(1 << DRAW_BITS)


def draw16(seed: torch.Tensor, plane, row, col) -> torch.Tensor:
    """16-bit draws (int64) of the elements at broadcastable int64
    coordinates, as csrc/philox.cuh:keep8 draws them."""
    s = seed.reshape(()).long() & MASK32
    ctr0 = ((row >> 4) << 3) | (row & 7)
    ctr1 = ((col >> 4) << 2) | ((col >> 1) & 3)
    o0, o1, o2, o3 = philox4x32_10((ctr0, ctr1, plane, 0), (s, 0))
    hi_row, hi_col = ((row >> 3) & 1) == 1, ((col >> 3) & 1) == 1
    word = torch.where(hi_row, torch.where(hi_col, o3, o2),
                       torch.where(hi_col, o1, o0))
    return (word >> (DRAW_BITS * (col & 1))) & 0xFFFF


def _coords(x: Union[int, torch.Tensor], device) -> torch.Tensor:
    if isinstance(x, int):
        return torch.arange(x, device=device)
    return x.to(device=device, dtype=torch.int64)


def keep_mask(seed: torch.Tensor, rate: float,
              rows: Union[int, torch.Tensor], cols: Union[int, torch.Tensor],
              planes: Optional[Union[int, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Bool keep mask: [rows, cols] on plane 0, or [planes, rows, cols].
    Each of rows, cols, planes is a count (coordinates 0 .. n - 1) or a 1-D
    tensor of coordinates; the mask sits on the seed's device."""
    dev = seed.device
    r = _coords(rows, dev)[:, None]
    c = _coords(cols, dev)[None, :]
    thr = threshold(rate)
    if planes is None:
        return draw16(seed, 0, r, c) >= thr
    p = _coords(planes, dev)[:, None, None]
    return draw16(seed, p, r[None], c[None]) >= thr


def checked_seed(seed: Optional[torch.Tensor], rate: float,
                 device: torch.device, what: str) -> Optional[torch.Tensor]:
    """A kernel call's seed: None at rate 0, zeros when None at a rate
    above 0 (the reference's default), else ``seed`` once it is an int32
    [1] tensor on ``device``. Refuses a rate outside [0, 1)."""
    threshold(rate)
    if rate <= 0.0:
        return None
    if seed is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    if (tuple(seed.shape) != (1,) or seed.dtype != torch.int32
            or seed.device != device):
        raise ValueError(f"{what}: the seed must be an int32 [1] tensor on "
                         "the inputs' device")
    return seed


def launch_args(seed: Optional[torch.Tensor], rate: float):
    """(seed pointer, threshold, 1 / (1 - rate)): the dropout arguments of
    a C entry point; a null seed at rate 0."""
    if rate <= 0.0:
        return None, 0, 1.0
    return seed.data_ptr(), threshold(rate), 1.0 / (1.0 - rate)


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """A dropout seed for one kernel call: int32 [1] on ``device``, drawn
    from ``generator`` (the device's default generator when None). A
    generator on ``device`` draws there, without a host sync; a CPU
    generator draws on the CPU and the seed is copied to ``device``, so
    that runs on two devices fed equally seeded CPU generators draw the
    same seeds."""
    where = generator.device if generator is not None else device
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=where, dtype=torch.int32).to(device)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """x scaled by 1 / (1 - rate) where kept, 0 elsewhere, in x's dtype
    (the kernels' order: the scale is an fp32 product)."""
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))
