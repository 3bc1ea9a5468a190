"""Chunked iteration for long-form training: this package's own copy of
espnet_slurp_tpu/data/chunk_iter.py (host-side numpy; no caller in the
reference either).

Parity target: reference espnet2/iterators/chunk_iter_factory.py:1-209
(ChunkIterFactory: long utterances split into fixed-length chunks; chunks
from many utterances pooled and re-batched so every batch is one uniform
chunk length, so every step has one shape).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np


def chunk_iter_factory(
    dataset,
    chunk_length: int,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    stream: str = "speech",
    aligned: Sequence[str] = (),
    aligned_ratio: Optional[Dict[str, float]] = None,
    batch_adapter: Optional[Callable] = None,
    excess_mode: str = "drop",
) -> Callable[[int], Iterable]:
    """Factory(epoch) -> iterator of uniform-chunk batches.

    ``stream``: the long stream to chunk (samples). ``aligned``: other
    streams chunked in lockstep at ``aligned_ratio[name]`` times the chunk
    length (e.g. frame labels at hop 64 -> ratio 1/64). Trailing partials
    shorter than chunk_length are dropped (reference default).
    """
    ratios = aligned_ratio or {}

    def factory(epoch: int):
        rng = np.random.RandomState(seed + epoch)
        keys = list(dataset.keys)
        if shuffle:
            rng.shuffle(keys)
        pool: List[Dict[str, np.ndarray]] = []
        for uid in keys:
            _, data = dataset[uid]
            x = np.asarray(data[stream])
            n_chunks = len(x) // chunk_length
            for c in range(n_chunks):
                item = {stream: x[c * chunk_length:(c + 1) * chunk_length]}
                for name in aligned:
                    r = ratios.get(name, 1.0)
                    cl = int(chunk_length * r)
                    a = np.asarray(data[name])
                    item[name] = a[c * cl:(c + 1) * cl]
                pool.append(item)
                if len(pool) >= batch_size:
                    if shuffle:
                        rng.shuffle(pool)
                    yield _collate(pool[:batch_size], stream, batch_adapter)
                    pool = pool[batch_size:]
        if pool and excess_mode == "pad":
            while len(pool) < batch_size:
                pool.append(pool[len(pool) % max(len(pool), 1)])
            yield _collate(pool[:batch_size], stream, batch_adapter)

    return factory


def _collate(items, stream, batch_adapter):
    batch = {}
    for name in items[0]:
        batch[name] = np.stack([it[name] for it in items])
    batch[f"{stream}_lengths"] = np.full(
        (len(items),), batch[stream].shape[1], np.int32)
    if batch_adapter is not None:
        return batch_adapter(batch)
    return batch
