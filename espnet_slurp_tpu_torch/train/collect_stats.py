"""Collect-stats: the feature mean / variance statistics of global MVN and
the per-utterance shape file. Port of
espnet_slurp_tpu/train/collect_stats.py.

Each batch runs the frontend on ``device`` (the card unless given, e.g.
"cpu"), or with ``input_feats`` takes the batch's dumped feature matrices
as they are; the masked fp32 ``sum`` and ``sum_square`` over the valid
frames come to the host and are accumulated in fp64 in batch order, as the
reference accumulates them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..data.fileio import DatadirWriter
from ..ops.frontend import FrontendConfig, default_frontend
from ..ops.masks import length_mask
from ..utils.device import resolve_device


@torch.inference_mode()
def collect_stats(batches: Iterable[dict], frontend_cfg: FrontendConfig,
                  output_dir: str | Path, input_feats: bool = False,
                  device=None) -> dict:
    """batches: host batches {speech, speech_lengths, (uids)}.

    Writes {output_dir}/feats_stats.npz (count, sum, sum_square) and
    speech_shape ("<frames>,<n_mels>" per utterance, as the reference
    writes it); returns the stats. With ``input_feats`` the batches' speech
    is a [B, T, D] feature dump, aggregated directly."""
    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    total_s = total_sq = None
    total_n = 0
    writer = DatadirWriter(out)
    for batch in batches:
        speech = torch.as_tensor(np.asarray(batch["speech"])).to(dev)
        lens = torch.as_tensor(np.asarray(batch["speech_lengths"])).to(dev)
        if input_feats:
            feats, flens = speech.float(), lens
        else:
            feats, flens = default_frontend(speech, lens, frontend_cfg)
        mask = length_mask(flens, feats.shape[1])[..., None]
        zero = torch.zeros((), device=dev)
        s = torch.where(mask, feats, zero).sum(dim=(0, 1))
        sq = torch.where(mask, feats ** 2, zero).sum(dim=(0, 1))
        s, sq = (x.cpu().numpy().astype(np.float64) for x in (s, sq))
        flens = flens.cpu().numpy()
        total_s = s if total_s is None else total_s + s
        total_sq = sq if total_sq is None else total_sq + sq
        total_n += int(flens.sum())
        for uid, fl in zip(batch.get("uids", []), flens):
            writer["speech_shape"][uid] = f"{int(fl)},{frontend_cfg.n_mels}"
    writer.close()
    stats = {"count": np.asarray(total_n), "sum": total_s,
             "sum_square": total_sq}
    np.savez(out / "feats_stats.npz", **stats)
    return stats
