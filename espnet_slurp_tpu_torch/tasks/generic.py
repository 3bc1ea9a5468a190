"""Shared runner for the task families that declare only their data streams
and model (the KA2G recipe, recipe/ka2g_run.py).

Port of espnet_slurp_tpu/tasks/generic.py: ``RunOptions``,
``simple_iter_factory``, ``run_training`` and ``load_config``. The
reference's ``run_training`` takes flax apply adapters
(``train_apply(params, batch, dropout_rng, specaug_rng)``); here the model
is an ``nn.Module`` whose ``forward(**batch, train=, generator=,
mvn_stats=)`` returns (loss, stats), as train/state.py:make_train_step
calls every model of the port, and ``init_fn(model, seed)`` draws its
parameters in place. The reference's mesh placement (data-parallel
replication over a device mesh) is ROADMAP.md queue 1 item 17 and raises.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
from torch import nn

from ..data.collate import common_collate
from ..data.prefetch import prefetch_to_device
from ..data.sampler import build_batches, epoch_shuffle
from ..train.checkpoint import CheckpointManager
from ..train.optim import OptimConfig, build_optimizer
from ..train.state import TrainState, make_eval_step, make_train_step
from ..train.trainer import Trainer, TrainerOptions
from ..utils.config import from_dict, load_yaml, merge_dicts, save_yaml

log = logging.getLogger("espnet_slurp_tpu_torch")


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """Trainer-side options shared by every task config."""
    max_epoch: int = 20
    patience: Optional[int] = None
    keep_nbest: int = 5
    nbest_average: int = 1
    log_interval: int = 50
    resume: bool = True
    seed: int = 0


def simple_iter_factory(dataset, batch_adapter: Callable, batch_size: int,
                        seed: int, shuffle: bool,
                        bucket_multiples: Optional[Dict[str, int]] = None,
                        shapes: Optional[Dict] = None):
    """Sorted fixed-size batches over a SpeechDataset-like object."""
    if shapes is None:
        shapes = {}
        for uid in dataset.keys:
            _, d = dataset[uid]
            first = next(iter(d.values()))
            shapes[uid] = (np.asarray(first).shape[0],)
    batches = build_batches([shapes], batch_type="sorted",
                            batch_size=batch_size)

    def factory(epoch: int):
        bs = epoch_shuffle(batches, seed, epoch) if shuffle else batches
        for utts in bs:
            items = [dataset[u] for u in utts]
            uids, coll = common_collate(items,
                                        bucket_multiples=bucket_multiples)
            yield batch_adapter(uids, coll)

    return factory


def run_training(*, exp_dir: str, model: nn.Module, train_factory,
                 valid_factory, optim: OptimConfig, run: RunOptions,
                 init_fn: Optional[Callable] = None, mvn_stats=None,
                 mesh=None, resolved_cfg=None) -> TrainState:
    """The Trainer over ``model``'s train and eval steps; the model trains
    in place on the device its parameters are on. Returns the final
    TrainState.

    ``init_fn(model, seed)`` draws the parameters (skipped when it is None:
    the model keeps the ones it has); batches are {name: array or tensor}
    with ``model.forward``'s keywords, sent to the model's device two steps
    ahead on a producer thread (data/prefetch.py)."""
    if mesh is not None:
        raise NotImplementedError(
            "run_training: mesh placement is not ported yet (ROADMAP.md "
            "queue 1 item 17)")
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    if resolved_cfg is not None:
        save_yaml(resolved_cfg, exp / "config.yaml")
    if init_fn is not None:
        init_fn(model, run.seed)
    dev = next(model.parameters()).device
    tx = build_optimizer(optim)
    state = TrainState.create(model, tx, seed=run.seed,
                              ema=optim.ema_decay > 0)
    ckpt = CheckpointManager(exp, run.keep_nbest)
    trainer = Trainer(
        model,
        make_train_step(model, tx, mvn_stats=mvn_stats,
                        grad_noise_eta=optim.grad_noise_eta,
                        ema_decay=optim.ema_decay),
        make_eval_step(model, mvn_stats=mvn_stats), ckpt,
        TrainerOptions(max_epoch=run.max_epoch, patience=run.patience,
                       keep_nbest=run.keep_nbest,
                       nbest_average=run.nbest_average,
                       log_interval=run.log_interval, resume=run.resume))
    return trainer.run(
        state, lambda epoch: prefetch_to_device(train_factory(epoch), dev),
        valid_factory)


def load_config(cls, path=None, overrides=None):
    d = load_yaml(path) if path else {}
    if overrides:
        d = merge_dicts(d, overrides)
    return from_dict(cls, d)
