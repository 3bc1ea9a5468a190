"""Train state and the train / eval steps.

Port of espnet_slurp_tpu/train/state.py.

The reference jits one step: forward, backward, clip, optimizer update,
non-finite skip. Here the same step runs eagerly: the model's own
parameters (fp32 masters; the layers compute in ``cfg.dtype``) are updated
in place, and ``TrainState`` holds the rest: the step counter, the
optimizer state, one ``torch.Generator`` on the model's device for SpecAug
and dropout (the seed of each K2 / K3 call, the eager routes' masks; a
step draws them on the device, with no host sync), the optional EMA
shadow and the divergence guard's ``lr_scale`` / grad-norm EMA. bf16
compute with fp32 parameters needs no GradScaler.

Semantics kept from the reference:
- a step whose loss or gradient norm is not finite, or (with
  ``spike_factor``, after step 20) whose norm exceeds spike_factor times
  the accepted-step EMA, changes neither the parameters nor the optimizer
  state (moments, its "step" count and, with ``accum_grad``, the running
  mean and the mini-step count, as the reference's ``jnp.where`` over the
  whole optax.MultiSteps state); ``TrainState.step`` still counts it;
- the grad-norm EMA moves on accepted steps only;
- ``lr_scale`` multiplies the final update; the EMA shadow follows the
  (possibly unchanged) parameters;
- gradient noise sigma^2 = eta / (1 + step)^0.55, drawn from the state's
  generator.
The skip is a select on the device (no host sync), as the reference's
``jnp.where``. The update works on the gradient as one flat fp32 vector
(its norm is computed once, for the skip test and the clip): clip, moments,
skip select and the parameter update are each one or a few kernels, not a
loop over the model's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.profiler import record_function

from .optim import Optimizer, flatten


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int64 scalar on the model's device
    opt_state: Dict
    generator: torch.Generator
    ema_params: Optional[List[torch.Tensor]] = None
    lr_scale: Optional[torch.Tensor] = None
    gnorm_ema: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer, seed: int = 0,
               ema: bool = False, guard: bool = False) -> "TrainState":
        params = [p for p in model.parameters() if p.requires_grad]
        dev = params[0].device
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(step=torch.zeros((), dtype=torch.int64, device=dev),
                   opt_state=tx.init(params),
                   generator=torch.Generator(device=dev).manual_seed(seed),
                   ema_params=[p.detach().clone() for p in params]
                   if ema else None,
                   lr_scale=torch.ones((), **f32) if guard else None,
                   gnorm_ema=torch.zeros((), **f32) if guard else None)


def make_train_step(model: nn.Module, tx: Optimizer, mvn_stats=None,
                    grad_noise_eta: float = 0.0, ema_decay: float = 0.0,
                    spike_factor: float = 0.0,
                    aux_loss_fn: Optional[Callable] = None) -> Callable:
    """(state, batch) -> (state, stats). ``batch`` holds the keyword
    arguments of ``model.forward`` (speech, speech_lengths, text,
    text_lengths, and a biasing batch's trie keys) on the model's device.
    stats: the model's (loss, loss_ctc, loss_att, acc, and loss_moe_aux /
    loss_interctc where the model has them) plus grad_norm and skipped
    (and spike_skipped with ``spike_factor``), as 0-d tensors.

    ``aux_loss_fn(batch) -> (loss, stats)`` adds a differentiable term to
    the same step (MBR's expected risk, train/mbr.py:make_mbr_aux_loss);
    its stats join the step's and ``loss`` is the sum."""
    params = [p for p in model.parameters() if p.requires_grad]
    sizes = [p.numel() for p in params]

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        for p in params:
            p.grad = None
        with record_function("train_step.forward"):
            loss, stats = model(**batch, train=True,
                                generator=state.generator,
                                mvn_stats=mvn_stats)
            if aux_loss_fn is not None:
                aux, aux_stats = aux_loss_fn(batch)
                loss = loss + aux
                stats = {**stats, **aux_stats, "loss": loss}
        with record_function("train_step.backward"):
            loss.backward()
        with torch.no_grad(), record_function("train_step.update"):
            grad = flatten([torch.zeros_like(p) if p.grad is None else p.grad
                            for p in params])
            if grad_noise_eta > 0:
                sigma = torch.sqrt(grad_noise_eta
                                   / (1.0 + state.step.float()) ** 0.55)
                grad = grad + sigma * torch.randn(
                    grad.shape, device=grad.device, generator=state.generator)
            gnorm = torch.linalg.vector_norm(grad)
            ok = torch.isfinite(gnorm) & torch.isfinite(loss.detach())
            stats = {k: v.detach() for k, v in stats.items()}
            gnorm_ema = state.gnorm_ema
            guarded = spike_factor > 0 and state.gnorm_ema is not None
            if guarded:
                warm = state.step > 20
                spike = warm & (gnorm > spike_factor
                                * state.gnorm_ema.clamp_min(1e-6))
                ok = ok & ~spike
                stats["spike_skipped"] = spike.float()
                gnorm_ema = torch.where(
                    ok, torch.where(state.step == 0, gnorm,
                                    0.95 * state.gnorm_ema + 0.05 * gnorm),
                    state.gnorm_ema)
            update, new_opt = tx.update(grad, gnorm, state.opt_state, params)
            if state.lr_scale is not None:
                update = update * state.lr_scale
            # A skipped step adds exact zeros and keeps the old moments.
            update = torch.where(ok, update, 0.0)
            torch._foreach_add_(params, [u.view_as(p) for u, p in
                                         zip(update.split(sizes), params)])
            opt_state = {k: torch.where(ok, new_opt[k], state.opt_state[k])
                         for k in new_opt}
            ema = state.ema_params
            if ema_decay > 0 and ema is not None:
                ema = list(torch._foreach_lerp(ema, params, 1.0 - ema_decay))
        stats["grad_norm"] = gnorm
        stats["skipped"] = 1.0 - ok.float()
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state, ema_params=ema,
                                   gnorm_ema=gnorm_ema), stats

    return step_fn


def make_eval_step(model: nn.Module, mvn_stats=None) -> Callable:
    """(state, batch) -> stats of ``model.forward(train=False)``, with the
    EMA shadow's weights when the state has one."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            if state.ema_params is None:
                _, stats = model(**batch, train=False, mvn_stats=mvn_stats)
            else:
                _, stats = torch.func.functional_call(
                    model, dict(zip(names, state.ema_params)), (),
                    dict(batch, train=False, mvn_stats=mvn_stats))
        return stats

    return step_fn
