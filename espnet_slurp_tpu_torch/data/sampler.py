"""Batch samplers with bucket discipline: this package's own copy of
espnet_slurp_tpu/data/sampler.py.

Parity target: reference espnet2/samplers/ (unsorted/sorted/folded/length/
numel strategies, built from precomputed shape files —
build_batch_sampler.py:72-162). As in the reference, batches are
length-sorted and padded shapes are rounded up to bucket boundaries so the
number of distinct padded shapes stays small.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Dict, List, Sequence, Tuple

import numpy as np

from .fileio import read_2column_text


def read_shape_file(path: str) -> Dict[str, Tuple[int, ...]]:
    """'uttid 123,80' lines -> {uttid: (123, 80)} (first dim = length)."""
    return {k: tuple(int(x) for x in v.split(","))
            for k, v in read_2column_text(path).items()}


@dataclasses.dataclass
class BatchSpec:
    utt_ids: List[str]


def build_batches(
    shapes: Sequence[Dict[str, Tuple[int, ...]]],
    batch_type: str = "numel",
    batch_size: int = 32,
    batch_bins: int = 4_000_000,
    sort_in_batch: str = "descending",
    min_batch_size: int = 1,
    drop_last: bool = False,
    fold_length: Optional[Sequence[int]] = None,
    utt2category: Optional[Dict[str, str]] = None,
    batch_size_multiple: int = 1,
) -> List[List[str]]:
    """Build the global batch list (rank sharding happens later, like
    abs_task.py:1533-1542 but per-host slices of each batch).

    shapes: one dict per stream (speech first). Keys must agree.
    batch_type (samplers/build_batch_sampler.py:12-69 BATCH_TYPES):
      - 'unsorted'/'sorted': fixed batch_size
      - 'folded': batch size shrinks with length — bs_i =
        batch_size // max(1, ceil(len_i / fold_length)) per stream
        (folded_batch_sampler semantics; fold_length defaults to the
        stream's mean length)
      - 'length': bins by sum of FIRST-dim lengths (batch_bins budget,
        length_batch_sampler)
      - 'numel': greedy bins by sum of padded elements (batch_bins budget)
    utt2category: optional {uttid: category} — batches never mix
    categories (samplers/category_balanced_sampler / utt2category file).
    batch_size_multiple: round every 'length'/'numel' batch's size DOWN to
    a multiple (the trimmed tail — the batch's shortest utts in the
    descending order — carries into the next batch; the final batch stays
    ragged). With padded lengths already geometric buckets, B bucketed too
    keeps the distinct batch shapes O(buckets), not O(distinct packed
    sizes); the reference added it for its compiler, and it is kept here
    so that both packages give the same batches.
    """
    keys = sorted(shapes[0], key=lambda k: -shapes[0][k][0])
    if utt2category is not None:
        # Partition keys by category, batch each partition independently.
        cats: Dict[str, list] = {}
        for k in keys:
            cats.setdefault(utt2category.get(k, ""), []).append(k)
        out: List[List[str]] = []
        for cat in sorted(cats):
            sub_shapes = [{k: sh[k] for k in cats[cat]} for sh in shapes]
            out.extend(build_batches(
                sub_shapes, batch_type=batch_type, batch_size=batch_size,
                batch_bins=batch_bins, sort_in_batch=sort_in_batch,
                min_batch_size=min_batch_size, drop_last=drop_last,
                fold_length=fold_length,
                batch_size_multiple=batch_size_multiple))
        return out
    if batch_type == "unsorted":
        keys = sorted(shapes[0])
        return [keys[i:i + batch_size]
                for i in range(0, len(keys), batch_size)]
    if batch_type == "sorted":
        return [keys[i:i + batch_size]
                for i in range(0, len(keys), batch_size)]
    if batch_type == "folded":
        folds = fold_length or [
            max(1, int(np.mean([v[0] for v in sh.values()])))
            for sh in shapes]
        batches = []
        cur: List[str] = []
        for k in keys:
            factor = max(
                -(-sh[k][0] // f) for sh, f in zip(shapes, folds))
            bs = max(min_batch_size, batch_size // max(1, factor))
            cur.append(k)
            if len(cur) >= bs:
                batches.append(cur)
                cur = []
        if cur and not drop_last:
            batches.append(cur)
        return batches
    if batch_type == "length":
        batches = []
        cur = []
        for k in keys:
            cand = cur + [k]
            total = sum(len(cand) * sh[cand[0]][0] for sh in shapes)
            if total > batch_bins and len(cur) >= min_batch_size:
                batches.append(cur)
                cur = [k]
            else:
                cur = cand
        if cur and not drop_last:
            batches.append(cur)
        return _apply_batch_multiple(batches, batch_size_multiple)
    if batch_type != "numel":
        raise ValueError(f"unknown batch_type {batch_type}")

    batches: List[List[str]] = []
    cur: List[str] = []
    for k in keys:  # descending length: padded size = first element's
        cand = cur + [k]
        # padded elements across all streams if we add k
        total = 0
        for sh in shapes:
            first = sh[cand[0]]
            feat = int(np.prod(first[1:])) if len(first) > 1 else 1
            total += len(cand) * first[0] * feat
        if total > batch_bins and len(cur) >= min_batch_size:
            batches.append(cur)
            cur = [k]
        else:
            cur = cand
    if cur and not drop_last:
        batches.append(cur)
    return _apply_batch_multiple(batches, batch_size_multiple)


def _apply_batch_multiple(batches: List[List[str]],
                          m: int) -> List[List[str]]:
    """Round each batch's size down to a multiple of m, carrying the tail
    (the shortest utts of that batch in descending order) into the next
    batch; the final batch keeps its ragged size (one extra compile)."""
    if m <= 1:
        return batches
    out: List[List[str]] = []
    carry: List[str] = []
    for b in batches:
        b = carry + b
        keep = (len(b) // m) * m
        if keep == 0:
            carry = b
            continue
        out.append(b[:keep])
        carry = b[keep:]
    if carry:
        out.append(carry)
    return out


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


def shard_batches(batches: List[List[str]], rank: int, world: int,
                  ) -> List[List[str]]:
    """Per-host slice of every global batch (abs_task.py:1533-1542 semantics:
    batch[rank::world]); requires len(batch) >= world."""
    out = []
    for b in batches:
        if len(b) < world:
            raise ValueError(f"batch size {len(b)} < world size {world}")
        out.append(b[rank::world])
    return out


def epoch_shuffle(batches: List[List[str]], seed: int, epoch: int
                  ) -> List[List[str]]:
    """Reproducible epoch-seeded shuffle (sequence_iter_factory.py:34-43)."""
    rng = np.random.RandomState(seed + epoch)
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]
