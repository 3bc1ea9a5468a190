"""Metric aggregation + epoch history. Port of
espnet_slurp_tpu/train/reporter.py (``Reporter`` and its JSON format are a
copy).

Parity target: reference espnet2/train/reporter.py (SubReporter/Reporter:
weighted averages per epoch, best-epoch queries, early stopping,
state_dict for resume — SURVEY.md §2.1).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch


class SubReporter:
    """Accumulates weighted stats within one epoch phase (train/valid).

    Values may be 0-d tensors on the card: their sums stay ON THE DEVICE
    (a ``.item()`` per step would force a host sync every step, and the
    bf16 flagship step is paced by the host, its card idle half of the
    step), and ``mean()`` reads them all in one transfer.
    """

    def __init__(self):
        self._sum: Dict[str, object] = {}
        self._weight: Dict[str, float] = defaultdict(float)
        self._count = 0
        self._t0 = time.perf_counter()

    def register(self, stats: Dict[str, object], weight: float = 1.0):
        for k, v in stats.items():
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach()
            prev = self._sum.get(k)
            self._sum[k] = v * weight if prev is None else prev + v * weight
            self._weight[k] += weight
        self._count += 1

    @property
    def steps(self) -> int:
        return self._count

    def mean(self) -> Dict[str, float]:
        sums = {k: float(v) for k, v in self._sum.items()
                if not isinstance(v, torch.Tensor)}
        tensors = {k: v for k, v in self._sum.items()
                   if isinstance(v, torch.Tensor)}
        by_device: Dict[torch.device, List[str]] = {}
        for k, v in tensors.items():
            by_device.setdefault(v.device, []).append(k)
        for keys in by_device.values():
            values = torch.stack([tensors[k].reshape(()).double()
                                  for k in keys]).tolist()
            sums.update(zip(keys, values))
        out = {k: sums[k] / max(self._weight[k], 1e-12) for k in self._sum}
        out["time_s"] = time.perf_counter() - self._t0
        out["steps"] = self._count
        return out


class Reporter:
    """Epoch history with best-epoch tracking and JSON persistence."""

    def __init__(self):
        self.history: List[Dict] = []  # [{epoch, train: {...}, valid: {...}}]

    def observe(self, epoch: int, phase: str, stats: Dict[str, float]):
        entry = self._entry(epoch)
        entry[phase] = stats

    def _entry(self, epoch: int) -> Dict:
        for e in self.history:
            if e["epoch"] == epoch:
                return e
        e = {"epoch": epoch}
        self.history.append(e)
        return e

    def get_value(self, epoch: int, phase: str, key: str) -> Optional[float]:
        for e in self.history:
            if e["epoch"] == epoch:
                return e.get(phase, {}).get(key)
        return None

    def sort_epochs(self, phase: str, key: str, mode: str = "min") -> List[int]:
        """Epochs sorted best-first by (phase, key) (reporter.py:388)."""
        vals = [(e.get(phase, {}).get(key), e["epoch"]) for e in self.history
                if e.get(phase, {}).get(key) is not None]
        rev = mode == "max"
        return [ep for _, ep in sorted(vals, reverse=rev)]

    def best_epoch(self, phase: str, key: str, mode: str = "min") -> Optional[int]:
        eps = self.sort_epochs(phase, key, mode)
        return eps[0] if eps else None

    def check_early_stopping(self, patience: int, phase: str, key: str,
                             mode: str = "min") -> bool:
        best = self.best_epoch(phase, key, mode)
        if best is None or not self.history:
            return False
        current = max(e["epoch"] for e in self.history)
        return (current - best) > patience

    def state_dict(self) -> Dict:
        return {"history": self.history}

    def load_state_dict(self, d: Dict):
        self.history = list(d["history"])

    def save(self, path: str | Path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.state_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str | Path) -> "Reporter":
        r = cls()
        with open(path) as f:
            r.load_state_dict(json.load(f))
        return r

    def log_line(self, epoch: int) -> str:
        e = self._entry(epoch)
        parts = [f"epoch {epoch}"]
        for phase in ("train", "valid"):
            if phase in e:
                kv = ", ".join(f"{k}={v:.4g}" for k, v in e[phase].items()
                               if isinstance(v, (int, float)))
                parts.append(f"[{phase}] {kv}")
        return " | ".join(parts)
