"""Optimizers and learning-rate schedules.

Port of espnet_slurp_tpu/train/optim.py.

The reference builds an optax chain: clip_by_global_norm -> the core
(scale_by_adam, trace, scale_by_adadelta, scale_by_rss or scale_by_rms) ->
add_decayed_weights -> scale_by_learning_rate(schedule), wrapped in
optax.MultiSteps when ``accum_grad`` > 1. ``Optimizer`` computes the same
update on the parameters as one flat fp32 vector (the optimizer's state is
flat too, so each step of the chain is one kernel whatever the number of
tensors), and functionally: ``update`` returns new state and changes
nothing, so the train step can keep the old state on a skipped step, as
the reference does. Where PyTorch's own tools differ from optax, optax is
followed:

- clipping scales by max_norm / norm when norm >= max_norm (optax), not by
  max_norm / (norm + 1e-6) (``torch.nn.utils.clip_grad_norm_``);
- the learning rate of update k (k counted from 0, on accepted updates only)
  is sched(k), and warmuplr / noam / warmup_step clamp the step to >= 1;
- Adam's bias correction uses the count after the increment, eps outside the
  square root (optax.scale_by_adam with eps_root 0);
- sgd is plain or with a momentum trace (t = g + momentum t, no dampening);
  adadelta (rho), adagrad (from a zero accumulator) and rmsprop (decay
  0.99, eps inside the square root) floor eps at 1e-8, as the reference
  does;
- ``accum_grad`` k > 1 is optax.MultiSteps: each mini-step folds its
  gradient into a running mean, the inner chain (clipping included, by
  the mean's norm) runs on the mean and its update is applied on every
  k-th mini-step only, zero between; the inner state (Adam's moments, the
  schedule's count) advances on those steps only. The mean and the
  mini-step count are part of the state, so a skipped (non-finite)
  mini-step rolls them back with the rest (train/state.py).

``OptimConfig`` has every field of the reference's, with its defaults.
An unknown optimizer or schedule raises ValueError, as the reference's.
Gradient noise, the EMA shadow and the spike guard (``grad_noise_eta``,
``ema_decay``, ``spike_factor``, on by default as there) are arguments of
``make_train_step``, which ``tasks/asr.py:ASRTask.train`` passes from the
config, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adam"
    lr: float = 2e-3
    scheduler: str = "warmuplr"
    warmup_steps: int = 25000
    d_model: int = 256  # used by "noam"
    decay_rate: float = 0.96     # exponential / warmup_step decay factor
    decay_steps: int = 10000     # exponential / cosine horizon, step period
    momentum: float = 0.0        # sgd momentum
    rho: float = 0.95            # adadelta decay
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.98)
    eps: float = 1e-9
    grad_clip: float = 5.0
    accum_grad: int = 1
    grad_noise_eta: float = 0.0   # trainer.py add_gradient_noise analogue
    ema_decay: float = 0.0        # v1 EMA wrapper analogue (asr.py:713-715)
    # Divergence guard: skip updates whose grad norm exceeds spike_factor x
    # the accepted-step EMA (train/state.py). 0 disables.
    spike_factor: float = 10.0


OPTIMIZERS = ("adam", "adamw", "sgd", "adadelta", "adagrad", "rmsprop")


def build_schedule(cfg: OptimConfig) -> Callable:
    """step (int or tensor) -> learning rate (fp32 tensor on step's
    device)."""
    def as_step(step):
        return torch.as_tensor(step, dtype=torch.float32)

    def warmuplr(s):
        return cfg.lr * cfg.warmup_steps ** 0.5 * torch.minimum(
            s ** -0.5, s * cfg.warmup_steps ** -1.5)

    if cfg.scheduler == "constant":
        return lambda step: torch.full_like(as_step(step), cfg.lr)
    if cfg.scheduler == "warmuplr":
        return lambda step: warmuplr(as_step(step).clamp_min(1.0))
    if cfg.scheduler == "noam":
        def sched(step):
            s = as_step(step).clamp_min(1.0)
            return cfg.lr * cfg.d_model ** -0.5 * torch.minimum(
                s ** -0.5, s * cfg.warmup_steps ** -1.5)
        return sched
    if cfg.scheduler == "warmup_step":
        # warmuplr's shape, then x decay_rate every decay_steps past warmup.
        def sched(step):
            s = as_step(step).clamp_min(1.0)
            k = torch.floor((s - cfg.warmup_steps).clamp_min(0.0)
                            / cfg.decay_steps)
            return warmuplr(s) * cfg.decay_rate ** k
        return sched
    if cfg.scheduler == "exponential":
        return lambda step: cfg.lr * cfg.decay_rate ** (
            as_step(step) / cfg.decay_steps)
    if cfg.scheduler == "cosine":
        def sched(step):
            s = as_step(step).clamp_max(float(cfg.decay_steps))
            return cfg.lr * 0.5 * (1.0 + torch.cos(
                math.pi * s / cfg.decay_steps))
        return sched
    raise ValueError(f"unknown scheduler {cfg.scheduler}")


def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors as one flat fp32 vector (a copy), in order."""
    return torch.cat([x.reshape(-1).float() for x in tensors])


class Optimizer:
    """The reference's optax chain for every optimizer it names, as pure
    functions of the flat gradient, its global norm, the state and the
    parameters."""

    def __init__(self, cfg: OptimConfig):
        if cfg.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.name}")
        self.cfg = cfg
        self.schedule = build_schedule(cfg)
        self.eps = max(cfg.eps, 1e-8)  # the floor of the non-Adam cores

    def _moments(self) -> Tuple[str, ...]:
        return {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
                "sgd": ("trace",) if self.cfg.momentum > 0 else (),
                "adadelta": ("e_g", "e_x"), "adagrad": ("sum_sq",),
                "rmsprop": ("nu",)}[self.cfg.name]

    def init(self, params: List[torch.Tensor]) -> Dict:
        """"step": the inner chain's count (Adam's and the schedule's,
        advanced on applied updates only); the core's flat moments; with
        accum_grad > 1, "acc" (the running mean) and "mini_step"."""
        n = sum(p.numel() for p in params)
        dev = params[0].device
        zeros = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
        count = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        state = {"step": count(), **{k: zeros() for k in self._moments()}}
        if self.cfg.accum_grad > 1:
            state.update(acc=zeros(), mini_step=count())
        return state

    def _core(self, g: torch.Tensor, state: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
        c, name, new = self.cfg, self.cfg.name, {}
        if name in ("adam", "adamw"):
            b1, b2 = c.betas
            count = (state["step"] + 1).float()
            new["mu"] = b1 * state["mu"] + (1.0 - b1) * g
            new["nu"] = b2 * state["nu"] + (1.0 - b2) * g * g
            return ((new["mu"] / (1.0 - b1 ** count))
                    / (torch.sqrt(new["nu"] / (1.0 - b2 ** count)) + c.eps),
                    new)
        if name == "sgd":
            if c.momentum > 0:
                new["trace"] = g + c.momentum * state["trace"]
                return new["trace"], new
            return g, new
        if name == "adadelta":
            new["e_g"] = (1.0 - c.rho) * g * g + c.rho * state["e_g"]
            up = (torch.sqrt(state["e_x"] + self.eps)
                  / torch.sqrt(new["e_g"] + self.eps)) * g
            new["e_x"] = (1.0 - c.rho) * up * up + c.rho * state["e_x"]
            return up, new
        if name == "adagrad":
            new["sum_sq"] = g * g + state["sum_sq"]
            return torch.where(new["sum_sq"] > 0,
                               torch.rsqrt(new["sum_sq"] + self.eps),
                               torch.zeros_like(g)) * g, new
        new["nu"] = 0.01 * g * g + 0.99 * state["nu"]  # rmsprop
        return torch.rsqrt(new["nu"] + self.eps) * g, new

    def _inner(self, grad, norm, state, params):
        """The inner chain: clip, core, decay, lr."""
        c = self.cfg
        if c.grad_clip > 0:
            grad = grad * torch.where(norm < c.grad_clip,
                                      torch.ones_like(norm),
                                      c.grad_clip / norm)
        update, new = self._core(grad, state)
        if c.weight_decay > 0:
            update = update + c.weight_decay * flatten(params)
        lr = self.schedule(state["step"])  # on the device: no host sync
        new["step"] = state["step"] + 1
        return -lr * update, new

    def update(self, grad: torch.Tensor, norm: torch.Tensor, state: Dict,
               params: List[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """grad: the flat fp32 gradient (``flatten``), norm: its global
        norm -> (flat update, new_state); nothing is changed in place."""
        k = self.cfg.accum_grad
        if k <= 1:
            return self._inner(grad, norm, state, params)
        mini = state["mini_step"]
        acc = state["acc"] + (grad - state["acc"]) / (mini + 1).float()
        update, inner = self._inner(acc, torch.linalg.vector_norm(acc),
                                    state, params)
        emit = mini == k - 1
        new = {key: torch.where(emit, v, state[key])
               for key, v in inner.items()}
        new["acc"] = torch.where(emit, torch.zeros_like(acc), acc)
        new["mini_step"] = (mini + 1) % k
        return torch.where(emit, update, torch.zeros_like(update)), new


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)
