"""Routed mixture-of-experts feed-forward (Switch, top-1). Port of
espnet_slurp_tpu/models/moe.py:MoEFeedForward.

The reference dispatches with a one-hot [S, E, C] einsum and combines
with its gate-weighted transpose. At conf/train_moe.yaml's width on 64 x
15 s utterances (S 29,952, E 8, C 4,680) that tensor alone is 4.5 GB a
layer in fp32, so the port computes the same function by index:

- the router (fp32 Linear, softmax) gives each token s its top-1 expert
  e(s) (the first on ties, as jnp.argmax) and gate;
- pos(s), the token's 0-based slot in its expert's buffer, is a cumulative
  count over the flattened [B T] order in which padded frames claim no
  slot; tokens with pos >= C are dropped (the residual carries them);
- the kept tokens are gathered (in fp32, then cast to the compute dtype)
  into [E, C, D] buffers, run through the experts as batched products
  (``torch.baddbmm``) with swish between, and gate(s) * out[e(s), pos(s)]
  is gathered back in fp32.

Every other rule is the reference's: C = max(int(S / E * capacity), 1)
from the padded S, and the load-balance loss E * sum_e density_e *
mean-gate_e over the valid tokens only. No host sync: the slot of each
token and the token of each slot are built by scatter on the device. Each
gather's backward adds into rows that one token at most owns, so the
gradients are the einsum's: the router gets its gradient through the gate
and the aux loss only. The expert weights are [E, in, out] tensors, as
the reference's params, with biases [E, out].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class MoEFeedForward(nn.Module):
    """[B, T, D] -> ([B, T, D], aux loss scalar)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int = 4,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        e = num_experts
        self.router = Linear(d_model, e)
        self.w1 = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.b1 = nn.Parameter(torch.zeros(e, d_ff))
        self.w2 = nn.Parameter(torch.empty(e, d_ff, d_model))
        self.b2 = nn.Parameter(torch.zeros(e, d_model))
        for w in (self.w1, self.w2):  # flax's lecun_normal fan_in: E x in
            nn.init.normal_(w, 0.0, (w.shape[0] * w.shape[1]) ** -0.5)

    def capacity(self, s: int) -> int:
        return max(int(s / self.num_experts * self.capacity_factor), 1)

    def route(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
        """x [B, T, D] -> (gates [S, E] fp32, expert [S] int64, pos [S]
        int64 (-1 at padded frames), keep [S] bool, aux loss), S = B T."""
        b, t, d = x.shape
        s, e = b * t, self.num_experts
        valid = (torch.ones(s, device=x.device) if pad_mask is None
                 else pad_mask.reshape(s).float())
        logits = F.linear(x.reshape(s, d).float(), self.router.weight.float(),
                          self.router.bias.float())
        gates = torch.softmax(logits, dim=-1)
        expert = gates.argmax(dim=-1)
        onehot = F.one_hot(expert, e).float() * valid[:, None]
        n_valid = valid.sum().clamp_min(1.0)
        density = onehot.sum(0) / n_valid
        density_proxy = (gates * valid[:, None]).sum(0) / n_valid
        aux = e * (density * density_proxy).sum()
        pos = (torch.cumsum(onehot, 0) * onehot).sum(-1).long() - 1
        keep = (pos >= 0) & (pos < self.capacity(s))
        return gates, expert, pos, keep, aux

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pad_mask [B, T] bool, True at valid frames: padded frames take
        no routing decision and no part in the aux loss."""
        b, t, d = x.shape
        s, e = b * t, self.num_experts
        cap = self.capacity(s)
        gates, expert, pos, keep, aux = self.route(x, pad_mask)
        gate = gates.gather(1, expert[:, None])[:, 0] * keep
        # Slot e * cap + pos of each kept token; e * cap (past every buffer,
        # a zero row) for the others.
        slot = torch.where(keep, expert * cap + pos,
                           torch.full_like(pos, e * cap))
        # The token of each slot; s (a zero row) for an empty one. Every
        # dropped token writes the spare slot e * cap, which is cut off.
        token = torch.full((e * cap + 1,), s, dtype=torch.long,
                           device=x.device)
        token.scatter_(0, slot, torch.arange(s, device=x.device))
        rows = F.pad(x.reshape(s, d).float(), (0, 0, 0, 1))
        buf = rows.index_select(0, token[:-1]).view(e, cap, d).to(x.dtype)
        dt = x.dtype
        h = F.silu(torch.baddbmm(self.b1.to(dt)[:, None], buf,
                                 self.w1.to(dt)))
        out = torch.baddbmm(self.b2.to(dt)[:, None], h, self.w2.to(dt))
        out = F.pad(out.reshape(e * cap, d).float(), (0, 0, 0, 1))
        y = out.index_select(0, slot) * gate[:, None]
        return y.reshape(b, t, d).to(x.dtype), aux
