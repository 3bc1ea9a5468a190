"""HuBERT SSL pretraining task.

Port of espnet_slurp_tpu/tasks/hubert.py (``HubertTaskConfig``,
``load_hubert_config``, ``HubertTask``) on the port's generic runner
(tasks/generic.py:run_training over train/state.py:make_train_step). A
data dir holds ``wav.scp`` and ``km``: the frame-level k-means ids at the
encoder's frame rate, one utterance a line (the ``text_int`` loader). Each
train step draws the span masks from its generator; the eval step masks
from a generator seeded 0, as the reference's PRNGKey(0).

One difference from the reference (ROADMAP.md queue 3): the reference's
``batch_adapter`` clamps the collated ids with ``np.maximum(ids, 0)``, so
the -1 that the collate pads a short ``km`` stream with becomes cluster 0
and those frames train toward it, against the model's own rule that -1
frames fall out of the loss. The port keeps the -1 (``batch_adapter``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..data.dataset import SpeechDataset
from ..models.hubert import HubertConfig, HubertModel
from ..train.optim import OptimConfig
from ..train.state import TrainState
from .asr import ASRTask
from .generic import (RunOptions, load_config, run_training,
                      simple_iter_factory)


@dataclasses.dataclass(frozen=True)
class HubertTaskConfig:
    exp_dir: str = "exp/hubert"
    model: HubertConfig = HubertConfig()
    optim: OptimConfig = OptimConfig(lr=1e-3, scheduler="constant")
    run: RunOptions = RunOptions()
    train_dir: str = ""
    valid_dir: str = ""
    batch_size: int = 8
    speech_bucket_multiple: int = 4096


def load_hubert_config(path=None, overrides=None) -> HubertTaskConfig:
    return load_config(HubertTaskConfig, path, overrides)


class HubertTask:
    @staticmethod
    def build_dataset(data_dir: str) -> SpeechDataset:
        return SpeechDataset(
            [(str(Path(data_dir) / "wav.scp"), "speech", "sound"),
             (str(Path(data_dir) / "km"), "cluster_ids", "text_int")])

    @staticmethod
    def batch_adapter(uids, coll):
        """A collated batch -> the model's keywords. The ids keep the
        collate's -1 padding (the reference clamps it to cluster 0)."""
        return {
            "speech": coll["speech"].astype(np.float32),
            "speech_lengths": coll["speech_lengths"],
            "cluster_ids": coll["cluster_ids"].astype(np.int32),
        }

    @classmethod
    def train(cls, cfg: HubertTaskConfig, device=None) -> TrainState:
        """Trains on ``device`` (the card unless given, e.g. "cpu"), the
        parameters drawn by the reference's initializers
        (tasks/asr.py:ASRTask.init_params) from ``run.seed``. Returns the
        final TrainState."""
        model = HubertModel(cfg.model, device=device)
        buckets = {"speech": cfg.speech_bucket_multiple}
        mk = lambda d, shuffle: simple_iter_factory(
            cls.build_dataset(d), cls.batch_adapter, cfg.batch_size,
            cfg.run.seed, shuffle, buckets)
        return run_training(
            exp_dir=cfg.exp_dir, model=model,
            init_fn=ASRTask.init_params,
            train_factory=mk(cfg.train_dir, True),
            valid_factory=mk(cfg.valid_dir, False),
            optim=cfg.optim, run=cfg.run, resolved_cfg=cfg)
