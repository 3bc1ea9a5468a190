"""Epoch-loop trainer. Port of espnet_slurp_tpu/train/trainer.py.

Parity target: reference espnet2/train/trainer.py:153-772 (Trainer.run:
resume, per-epoch train/validate, checkpoint + n-best retention, early
stopping, log_interval lines). The per-step work lives in the train step
(train/state.py); this loop is host-side orchestration: iterate bucketed
batches, move them to the model's device, aggregate stats.

Kept from the reference: resume from ``latest.json``, the per-step
``iter_time`` (waiting for the batch) and ``step_time`` (issuing the step),
the all-invalid abort, the divergence guard with its additive margin
(rollback to the best epoch's checkpoint, ``lr_scale`` backoff,
``guard_max``), early stopping and the n-best average. The tensorboard,
wandb and matplotlib sinks and the profiler window (reference
train/observe.py) are not ported yet (ROADMAP.md queue 1 item 17): their
options default to off here and raise when set.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..data.prefetch import to_device
from .checkpoint import CheckpointManager
from .reporter import Reporter, SubReporter

log = logging.getLogger("espnet_slurp_tpu_torch")


@dataclasses.dataclass
class TrainerOptions:
    max_epoch: int = 40
    patience: Optional[int] = None
    keep_nbest: int = 10
    criterion: tuple = ("valid", "loss", "min")
    log_interval: int = 50
    resume: bool = True
    nbest_average: int = 10
    # Observability sinks (the reference's default tensorboard and
    # plot_curves on): not ported yet, so off by default, and raise when set.
    tensorboard: bool = False
    use_wandb: bool = False
    wandb_project: Optional[str] = None
    plot_curves: bool = False
    profile_start_step: Optional[int] = None
    profile_stop_step: Optional[int] = None
    # Divergence guard (one step past reference trainer.py:651-670 +
    # e2e_asr.py:575-581): when the epoch's valid criterion explodes past
    # guard_factor x best-so-far (or goes non-finite), roll the model and
    # TrainState back to the best epoch's checkpoint and multiply the update
    # scale by guard_backoff. None disables. guard_max bounds total
    # rollbacks.
    guard_factor: Optional[float] = 5.0
    guard_backoff: float = 0.5
    guard_max: int = 3
    # |best| floor for the guard's additive margin (see _guard): bounds
    # the trigger sensitivity when the criterion sits near zero.
    guard_margin_floor: float = 1.0


class Trainer:
    """run(state, train/valid iter factories) -> final state; the model's
    parameters are trained in place."""

    def __init__(self, model: nn.Module, train_step: Callable,
                 eval_step: Callable, ckpt: CheckpointManager,
                 options: TrainerOptions):
        o = options
        asked = [name for name, on in (
            ("tensorboard", o.tensorboard), ("use_wandb", o.use_wandb),
            ("plot_curves", o.plot_curves),
            ("profile_start_step", o.profile_start_step is not None)) if on]
        if asked:
            raise NotImplementedError(
                f"TrainerOptions {asked}: the trainer's sinks and profiler "
                "window are not ported yet (ROADMAP.md queue 1 item 17)")
        self.model = model
        self.train_step = train_step
        self.eval_step = eval_step
        self.ckpt = ckpt
        self.options = options

    def _place(self, batch):
        """A batch on the model's device: numpy arrays through pinned host
        memory (data/prefetch.py:to_device), tensors moved, anything else
        as it is."""
        dev = next(self.model.parameters()).device
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
        out = dict(batch)
        out.update(to_device(arrays, dev))
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(dev, non_blocking=True)
        return out

    def _guard(self, state, reporter, epoch, phase, key, mode):
        """Divergence guard: rollback + LR backoff when the valid criterion
        explodes (guard_factor x best) or goes non-finite. Returns
        (state, rolled_back)."""
        o = self.options
        cur = reporter.get_value(epoch, phase, key)
        if cur is None:
            return state, False
        prev = [(e, reporter.get_value(e, phase, key))
                for e in range(1, epoch)]
        prev = [(e, v) for e, v in prev
                if v is not None and math.isfinite(v)
                and self.ckpt.epoch_dir(e).exists()]
        if not prev:
            return state, False
        best_epoch, best = (min if mode == "min" else max)(
            prev, key=lambda t: t[1])
        # Additive margins scaled by |best| — equivalent to the
        # multiplicative factor for positive criteria, but a NEGATIVE best
        # must not invert the threshold. The floor keeps near-zero criteria
        # from hair-triggering.
        ref = max(abs(best), o.guard_margin_floor)
        if mode == "min":
            diverged = (not math.isfinite(cur)) \
                or cur > best + (o.guard_factor - 1.0) * ref
        else:
            diverged = (not math.isfinite(cur)) \
                or cur < best - (1.0 - 1.0 / o.guard_factor) * ref
        if not diverged:
            return state, False
        state = self.ckpt.restore(best_epoch, self.model, state)
        if state.lr_scale is not None:
            state = dataclasses.replace(
                state, lr_scale=state.lr_scale * o.guard_backoff)
            scale = float(state.lr_scale)
        else:
            scale = 1.0
        log.warning(
            "divergence guard: epoch %d %s/%s=%.4g vs best %.4g (epoch %d, "
            "factor %.1f) — rolled back to epoch %d, lr_scale now %.3g",
            epoch, phase, key, cur, best, best_epoch, o.guard_factor,
            best_epoch, scale)
        return state, True

    def run(self, state, train_iter_factory: Callable[[int], Iterable],
            valid_iter_factory: Callable[[int], Iterable]):
        o = self.options
        reporter = Reporter()
        start_epoch = 1
        if o.resume:
            latest = self.ckpt.latest_epoch()
            if latest is not None:
                state = self.ckpt.restore(latest, self.model, state)
                reporter = self.ckpt.load_reporter()
                start_epoch = latest + 1
                log.info("resumed from epoch %d", latest)

        phase, key, mode = o.criterion
        n_rollbacks = 0
        for epoch in range(start_epoch, o.max_epoch + 1):
            sub = SubReporter()
            t_prev = time.perf_counter()
            for batch in train_iter_factory(epoch):
                t_data = time.perf_counter()
                batch = self._place(batch)
                state, stats = self.train_step(state, batch)
                t_step = time.perf_counter()
                # Section wall timers (trainer.py:502-555 measure_time
                # analogue): waiting for the batch vs issuing the step.
                sub.register({**stats,
                              "iter_time": t_data - t_prev,
                              "step_time": t_step - t_data})
                t_prev = t_step
                if sub.steps % o.log_interval == 0:
                    m = sub.mean()
                    log.info("epoch %d step %d loss=%.4f", epoch, sub.steps,
                             m.get("loss", float("nan")))
            train_mean = sub.mean()
            # All-invalid abort (trainer.py:434-440 all_steps_are_invalid):
            # an epoch where EVERY update was skipped for non-finite
            # gradients means training is diverged/broken — fail loudly
            # instead of burning epochs.
            if sub.steps > 0 and train_mean.get("skipped", 0.0) >= 1.0:
                raise RuntimeError(
                    f"all {sub.steps} steps of epoch {epoch} produced "
                    "non-finite gradients; aborting (check lr/loss scale)")
            reporter.observe(epoch, "train", train_mean)

            sub = SubReporter()
            for batch in valid_iter_factory(epoch):
                sub.register(self.eval_step(state, self._place(batch)))
            valid_mean = sub.mean()
            reporter.observe(epoch, "valid", valid_mean)
            log.info(reporter.log_line(epoch))

            if o.guard_factor is not None:
                state, rolled = self._guard(state, reporter, epoch,
                                            phase, key, mode)
                if rolled:
                    n_rollbacks += 1
                    if n_rollbacks > o.guard_max:
                        raise RuntimeError(
                            f"divergence guard rolled back {n_rollbacks} "
                            "times; training is unstable (check lr)")

            self.ckpt.save_epoch(epoch, self.model, state, reporter)
            if o.patience is not None and reporter.check_early_stopping(
                    o.patience, phase, key, mode):
                log.info("early stopping at epoch %d", epoch)
                break

        if o.nbest_average > 1:
            try:
                self.ckpt.average_nbest(reporter, o.nbest_average)
            except RuntimeError:
                pass
        return state
