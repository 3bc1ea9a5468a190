"""Feature normalisation. Port of espnet_slurp_tpu/ops/normalize.py."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .masks import length_mask


def global_mvn_params(stats: dict | str, eps: float = 1.0e-20
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Load (mean, inv_std) from a collect-stats npz (keys: count, sum,
    sum_square), given as a path or an in-memory dict; global_mvn.py:37-74
    math, in float64, returned as float32."""
    if isinstance(stats, str):
        stats = dict(np.load(stats))
    count = np.asarray(stats["count"], dtype=np.float64)
    mean = np.asarray(stats["sum"], dtype=np.float64) / count
    var = np.asarray(stats["sum_square"], dtype=np.float64) / count - mean**2
    std = np.sqrt(np.maximum(var, eps))
    return mean.astype(np.float32), (1.0 / std).astype(np.float32)


def mvn_tensors(mvn_stats, device):
    """(mean, inv_std) given as arrays or tensors -> fp32 tensors on
    ``device``; None stays None."""
    if mvn_stats is None:
        return None
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in mvn_stats)


def global_mvn(x: torch.Tensor, lengths: torch.Tensor, mean: torch.Tensor,
               inv_std: torch.Tensor, norm_means: bool = True,
               norm_vars: bool = True) -> torch.Tensor:
    """[B, T, F] normalised by precomputed stats; padding zeroed."""
    if norm_means:
        x = x - mean
    if norm_vars:
        x = x * inv_std
    mask = length_mask(lengths, x.shape[1])[..., None]
    return torch.where(mask, x, torch.zeros_like(x))


def utterance_mvn(x: torch.Tensor, lengths: torch.Tensor,
                  norm_means: bool = True, norm_vars: bool = False,
                  eps: float = 1.0e-20) -> torch.Tensor:
    """Per-utterance mean (and optionally variance) normalisation over the
    valid frames; padding zeroed."""
    mask = length_mask(lengths, x.shape[1])[..., None]
    zero = torch.zeros_like(x)
    denom = torch.clamp(lengths.to(x.dtype), min=1.0)[:, None, None]
    mean = torch.where(mask, x, zero).sum(dim=1, keepdim=True) / denom
    if norm_means:
        x = torch.where(mask, x - mean, zero)
        if norm_vars:
            var = torch.where(mask, x ** 2, zero).sum(dim=1,
                                                      keepdim=True) / denom
            x = torch.where(mask, x / torch.sqrt(torch.clamp(var, min=eps)),
                            zero)
        return x
    if norm_vars:
        var = torch.where(mask, (x - mean) ** 2, zero).sum(
            dim=1, keepdim=True) / denom
        x = x / torch.sqrt(torch.clamp(var, min=eps))
    return torch.where(mask, x, zero)
