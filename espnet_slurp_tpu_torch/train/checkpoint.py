"""Checkpoint / resume / n-best parameter averaging. Port of
espnet_slurp_tpu/train/checkpoint.py, with one ``torch.save`` file in place
of orbax.

Parity target: reference trainer.py:124-151,339-432 (checkpoint.pth with
model+reporter+optimizers, per-epoch weights, best symlinks, n-best pruning)
and main_funcs/average_nbest_models.py.

Layout, as in the reference: ``<exp>/<n>epoch/`` per kept epoch,
``latest.json`` ({"epoch": n}) and ``reporter.json`` beside them, and
``<phase>.<key>.ave_<k>best/`` for the n-best average. Each of those
directories holds one file, ``checkpoint.pth``:

- ``params``: the model's fp32 state_dict;
- ``opt_state``: the optimizer's flat state (train/optim.py);
- ``step``: the TrainState's step counter;
- ``generator``: the state of the train step's ``torch.Generator``, so a
  resumed run draws the same SpecAug and dropout stream on its device;
- ``ema_params``, ``lr_scale``, ``gnorm_ema`` when the state has them.

The average holds only ``params``. Everything is stored on the CPU and
loaded with ``weights_only=True``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from .reporter import Reporter

CKPT_FILE = "checkpoint.pth"
_OPTIONAL = ("ema_params", "lr_scale", "gnorm_ema")


def _cpu(x):
    if isinstance(x, (list, tuple)):
        return [t.detach().cpu() for t in x]
    return x.detach().cpu()


def _save(obj, path: Path) -> None:
    """torch.save through a temporary file, so a reader never sees half a
    checkpoint."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, exp_dir: str | Path, keep_nbest: int = 10,
                 criterion: tuple = ("valid", "loss", "min")):
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.keep_nbest = keep_nbest
        self.criterion = criterion

    # -- paths --
    def epoch_dir(self, epoch: int) -> Path:
        return self.exp_dir / f"{epoch}epoch"

    @property
    def latest_file(self) -> Path:
        return self.exp_dir / "latest.json"

    # -- save/load --
    def save_epoch(self, epoch: int, model: nn.Module, state,
                   reporter: Reporter):
        """Save the full train state for resume + record the latest epoch."""
        path = self.epoch_dir(epoch)
        if path.exists():
            shutil.rmtree(path)
        tree = {"params": {k: v.detach().float().cpu()
                           for k, v in model.state_dict().items()},
                "opt_state": {k: _cpu(v) for k, v in state.opt_state.items()},
                "step": _cpu(state.step),
                "generator": state.generator.get_state()}
        for f in _OPTIONAL:
            if getattr(state, f, None) is not None:
                tree[f] = _cpu(getattr(state, f))
        _save(tree, path / CKPT_FILE)
        reporter.save(self.exp_dir / "reporter.json")
        with open(self.latest_file, "w") as f:
            json.dump({"epoch": epoch}, f)
        self.prune(reporter)

    def latest_epoch(self) -> Optional[int]:
        if not self.latest_file.exists():
            return None
        with open(self.latest_file) as f:
            return json.load(f)["epoch"]

    def restore(self, epoch: int, model: nn.Module, state):
        """Load the parameters saved at ``epoch`` into ``model`` and return
        ``state`` with that epoch's optimizer state, step and generator
        state (the generator is set in place).

        Optional fields (EMA shadow, divergence-guard scalars) absent from a
        checkpoint keep the live state's values, as in the reference.
        """
        tree = _load(self.epoch_dir(epoch) / CKPT_FILE)
        model.load_state_dict(tree["params"])
        dev = state.step.device
        state.generator.set_state(tree["generator"])
        extra = {}
        for f in _OPTIONAL:
            if getattr(state, f, None) is not None and f in tree:
                v = tree[f]
                extra[f] = ([t.to(dev) for t in v] if isinstance(v, list)
                            else v.to(dev))
        return dataclasses.replace(
            state, step=tree["step"].to(dev),
            opt_state={k: v.to(dev) for k, v in tree["opt_state"].items()},
            **extra)

    def load_reporter(self) -> Reporter:
        p = self.exp_dir / "reporter.json"
        return Reporter.load(p) if p.exists() else Reporter()

    # -- retention --
    def prune(self, reporter: Reporter):
        """Keep n-best (by criterion) + latest epoch dirs (trainer.py:355-432)."""
        phase, key, mode = self.criterion
        keep = set(reporter.sort_epochs(phase, key, mode)[:self.keep_nbest])
        latest = self.latest_epoch()
        if latest is not None:
            keep.add(latest)
        for p in self.exp_dir.glob("*epoch"):
            try:
                ep = int(p.name.replace("epoch", ""))
            except ValueError:
                continue
            if ep not in keep:
                shutil.rmtree(p)

    def average_nbest(self, reporter: Reporter,
                      n: int = 10) -> Dict[str, torch.Tensor]:
        """Parameter-average the n best epochs (average_nbest_models.py:13):
        summed in float64, divided, stored as float32."""
        phase, key, mode = self.criterion
        epochs = [e for e in reporter.sort_epochs(phase, key, mode)[:n]
                  if self.epoch_dir(e).exists()]
        if not epochs:
            raise RuntimeError("no checkpoints to average")
        avg = None
        for e in epochs:
            p = _load(self.epoch_dir(e) / CKPT_FILE)["params"]
            if avg is None:
                avg = {k: v.double() for k, v in p.items()}
            else:
                for k, v in p.items():
                    avg[k] += v.double()
        avg = {k: (v / len(epochs)).float() for k, v in avg.items()}
        out = self.exp_dir / f"{phase}.{key}.ave_{len(epochs)}best"
        if out.exists():
            shutil.rmtree(out)
        _save({"params": avg}, out / CKPT_FILE)
        return avg

    def load_params(self, name: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
        """The parameters (a state_dict on the CPU) of a checkpoint by its
        directory name (e.g. '3epoch', 'valid.loss.ave_5best'); without a
        name, the n-best average ``valid.*best`` if there is one, else the
        latest epoch (the decoders' default)."""
        if name is None:
            cands = sorted(self.exp_dir.glob("valid.*best"))
            name = cands[0].name if cands else f"{self.latest_epoch()}epoch"
        return _load(self.exp_dir / name / CKPT_FILE)["params"]
