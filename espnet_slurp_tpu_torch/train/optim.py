"""Optimizer and learning-rate schedules.

Port of espnet_slurp_tpu/train/optim.py.

The reference builds an optax chain: clip_by_global_norm -> scale_by_adam ->
add_decayed_weights -> scale_by_learning_rate(schedule). ``Optimizer``
computes the same update on the parameters as one flat fp32 vector (the
moments are flat too, so each step of the chain is one kernel whatever the
number of tensors), and functionally: ``update`` returns new state and
changes nothing, so the train step can keep the old state on a skipped
step, as the reference does. Where PyTorch's own tools differ from optax,
optax is followed:

- clipping scales by max_norm / norm when norm >= max_norm (optax), not by
  max_norm / (norm + 1e-6) (``torch.nn.utils.clip_grad_norm_``);
- the learning rate of update k (k counted from 0, on accepted updates only)
  is sched(k), and warmuplr / noam clamp the step to >= 1;
- Adam's bias correction uses the count after the increment, eps outside the
  square root (optax.scale_by_adam with eps_root 0).

Ported: adam / adamw (the reference chains both the same way), global-norm
clipping, weight decay, and the constant / warmuplr / noam schedules. The
other optimizers and schedules and ``accum_grad`` > 1 raise
(ROADMAP.md queue 1); ``OptimConfig`` has every field of the reference's,
with its defaults, so a reference config loads. Gradient noise, the EMA
shadow and the spike guard (``grad_noise_eta``, ``ema_decay``,
``spike_factor``, on by default as there) are arguments of
``make_train_step``, which ``tasks/asr.py:ASRTask.train`` passes from the
config, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adam"
    lr: float = 2e-3
    scheduler: str = "warmuplr"
    warmup_steps: int = 25000
    d_model: int = 256  # used by "noam"
    # Read by the optimizers and schedules that are not ported yet (they
    # raise): exponential / warmup_step decay, sgd / rmsprop momentum,
    # adadelta's rho. Kept so that a reference config loads.
    decay_rate: float = 0.96
    decay_steps: int = 10000
    momentum: float = 0.0
    rho: float = 0.95
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


def build_schedule(cfg: OptimConfig) -> Callable:
    """step (int or tensor) -> learning rate (fp32 tensor on step's
    device)."""
    def as_step(step):
        return torch.as_tensor(step, dtype=torch.float32)

    if cfg.scheduler == "constant":
        return lambda step: torch.full_like(as_step(step), cfg.lr)
    if cfg.scheduler == "warmuplr":
        def sched(step):
            s = as_step(step).clamp_min(1.0)
            return cfg.lr * cfg.warmup_steps ** 0.5 * torch.minimum(
                s ** -0.5, s * cfg.warmup_steps ** -1.5)
        return sched
    if cfg.scheduler == "noam":
        def sched(step):
            s = as_step(step).clamp_min(1.0)
            return cfg.lr * cfg.d_model ** -0.5 * torch.minimum(
                s ** -0.5, s * cfg.warmup_steps ** -1.5)
        return sched
    raise NotImplementedError(
        f"scheduler {cfg.scheduler!r} is not ported yet (constant, warmuplr, "
        f"noam are)")


def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors as one flat fp32 vector (a copy), in order."""
    return torch.cat([x.reshape(-1).float() for x in tensors])


class Optimizer:
    """The reference's optax chain for adam / adamw, as pure functions of
    the flat gradient, its global norm, the state and the parameters."""

    def __init__(self, cfg: OptimConfig):
        if cfg.name not in ("adam", "adamw"):
            raise NotImplementedError(
                f"optimizer {cfg.name!r} is not ported yet (adam, adamw are)")
        if cfg.accum_grad > 1:
            raise NotImplementedError("accum_grad > 1 is not ported yet")
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def init(self, params: List[torch.Tensor]) -> Dict:
        n = sum(p.numel() for p in params)
        zeros = lambda: torch.zeros(n, dtype=torch.float32,
                                    device=params[0].device)
        # "step": Adam's count and the schedule's count (they advance
        # together, on accepted updates only); "mu", "nu": flat moments.
        return {"step": torch.zeros((), dtype=torch.int64,
                                    device=params[0].device),
                "mu": zeros(), "nu": zeros()}

    def update(self, grad: torch.Tensor, norm: torch.Tensor, state: Dict,
               params: List[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """grad: the flat fp32 gradient (``flatten``), norm: its global
        norm -> (flat update, new_state); nothing is changed in place."""
        c = self.cfg
        b1, b2 = c.betas
        if c.grad_clip > 0:
            grad = grad * torch.where(norm < c.grad_clip,
                                      torch.ones_like(norm),
                                      c.grad_clip / norm)
        count = state["step"] + 1
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()
        mu = b1 * state["mu"] + (1.0 - b1) * grad
        nu = b2 * state["nu"] + (1.0 - b2) * grad * grad
        update = (mu / c1) / (torch.sqrt(nu / c2) + c.eps)
        if c.weight_decay > 0:
            update = update + c.weight_decay * flatten(params)
        lr = self.schedule(state["step"])  # on the device: no host sync
        return -lr * update, {"step": count, "mu": mu, "nu": nu}


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)
