"""Length bucketing: this package's own copy of bucket_length from
espnet_slurp_tpu/data/sampler.py (the rest of the sampler comes with the
training slice)."""
from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_length(n: int, multiple: int, growth: float = 1.25) -> int:
    """Round n up to a geometric bucket boundary that is also a multiple.

    Bounds the number of distinct padded shapes to O(log(T_max)/log(growth)).
    """
    b = multiple
    while b < n:
        b = round_up(int(b * growth) + 1, multiple)
    return b
