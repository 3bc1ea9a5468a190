"""Batch collation with bucketed padding: this package's own copy of
espnet_slurp_tpu/data/collate.py.

Parity target: reference espnet2/train/collate_fn.py (CommonCollateFn: pad
each named stream to batch max, emit <name>_lengths) — with the reference's
addition that padded lengths are rounded UP to bucket boundaries, so a run
sees a bounded set of shapes (SURVEY.md §7 'bucketed padding'). The batches
stay numpy (text int32): the Trainer moves them to the model's device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .sampler import bucket_length


def common_collate(
    items: Sequence[Tuple[str, Dict[str, np.ndarray]]],
    float_pad_value: float = 0.0,
    int_pad_value: int = -1,
    not_sequence: Sequence[str] = (),
    bucket_multiples: Dict[str, int] | None = None,
    bucket_growth: float = 1.25,
    pad_to: Dict[str, int] | None = None,
) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """[(uid, {name: array})] -> (uids, {name: [B, L*, ...], name_lengths: [B]}).

    bucket_multiples maps stream name -> padding multiple; streams not listed
    are padded to exact batch max (collate_fn.py:41-99 behavior). ``pad_to``
    overrides the target length per stream — multi-process training collates
    each rank's slice of a global batch to the GLOBAL bucketed length so the
    per-process shards assemble into one consistent global array.
    """
    uids = [u for u, _ in items]
    names = items[0][1].keys()
    out: Dict[str, np.ndarray] = {}
    bucket_multiples = bucket_multiples or {}
    for name in names:
        arrays = [d[name] for _, d in items]
        if name in not_sequence or arrays[0].ndim == 0:
            out[name] = np.stack(arrays)
            continue
        lengths = np.array([a.shape[0] for a in arrays], dtype=np.int32)
        max_len = int(lengths.max())
        if name in bucket_multiples:
            max_len = bucket_length(max_len, bucket_multiples[name],
                                    bucket_growth)
        if pad_to and name in pad_to:
            max_len = max(pad_to[name], max_len)
        pad_value = (int_pad_value
                     if np.issubdtype(arrays[0].dtype, np.integer)
                     else float_pad_value)
        shape = (len(arrays), max_len) + arrays[0].shape[1:]
        buf = np.full(shape, pad_value, dtype=arrays[0].dtype)
        for i, a in enumerate(arrays):
            buf[i, :a.shape[0]] = a
        out[name] = buf
        out[f"{name}_lengths"] = lengths
    return uids, out


def asr_batch(uids, data) -> Dict[str, np.ndarray]:
    """Rename streams to the ASRModel argument names. A speech batch that
    is not a numpy array (a device tensor of data/resident.py) is kept as
    it is."""
    speech = data["speech"]
    out = {
        "speech": (speech.astype(np.float32)
                   if isinstance(speech, np.ndarray) else speech),
        "speech_lengths": data["speech_lengths"],
        "text": np.maximum(data["text"], 0).astype(np.int32),
        "text_lengths": data["text_lengths"],
    }
    # Multi-speaker PIT references (pit_espnet_model.py text_spk{n} keys).
    for name in data:
        if name.startswith("text_spk"):
            out[name] = (np.maximum(data[name], 0).astype(np.int32)
                         if not name.endswith("_lengths") else data[name])
    return out
