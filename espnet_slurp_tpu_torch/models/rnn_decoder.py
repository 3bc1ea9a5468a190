"""RNN (LAS) decoder with location-aware attention. Port of
espnet_slurp_tpu/models/rnn_decoder.py (``LocationAttention``,
``RNNDecoder``).

Each step attends with the previous step's weights refined by a 1-D conv
(AttLoc: e = g . tanh(W_enc h + W_dec z + W_f conv(att_prev)), the softmax
of 2 e over the valid frames, masked at -1e30 in fp32), then steps the
LSTM stack on [embed(y), context] and scores [h, context]. Teacher forcing
is a Python loop over the label positions (the recurrence is inherent).
Decoding uses the TransformerDecoder's interface: ``precompute_memory``
({"enc", "proj"}), ``init_cache(batch, t_enc, memory_lengths)`` (each
layer's (c, h) and ``att_prev``: uniform over the valid frames) and
``step``, whose cache the beam search gathers leaf by leaf. The LSTM's c and
h stay fp32, as models/layers.py:LSTMLayer keeps them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import length_mask
from .layers import Conv1d, LSTMLayer, Linear


class LocationAttention(nn.Module):
    def __init__(self, d_enc: int, d_dec: int, d_att: int = 320,
                 conv_chans: int = 10, conv_filts: int = 100,
                 scaling: float = 2.0):
        super().__init__()
        self.conv_filts, self.scaling = conv_filts, scaling
        self.loc_conv = Conv1d(1, conv_chans, 2 * conv_filts + 1, bias=False)
        self.mlp_att = Linear(conv_chans, d_att, bias=False)
        self.mlp_dec = Linear(d_dec, d_att)
        self.mlp_enc = Linear(d_enc, d_att, bias=False)
        self.gvec = Linear(d_att, 1, bias=False)

    def precompute(self, enc):
        return self.mlp_enc(enc)

    def forward(self, enc, enc_proj, enc_mask, dec_z, att_prev):
        """enc [B, T, De]; enc_proj [B, T, Da]; enc_mask [B, T] bool; dec_z
        [B, Dd]; att_prev [B, T] fp32 -> (ctx [B, De], w [B, T] fp32)."""
        dt = enc.dtype
        p = self.conv_filts
        loc = self.loc_conv(F.pad(att_prev.to(dt)[:, None], (p, p)))
        f = self.mlp_att(loc.transpose(1, 2))  # [B, T, Da]
        z = self.mlp_dec(dec_z.to(dt))
        e = self.gvec(torch.tanh(enc_proj + f + z[:, None, :]))[..., 0]
        e = torch.where(enc_mask, e.float(), torch.full_like(e.float(), -1e30))
        w = torch.softmax(self.scaling * e, dim=-1)
        ctx = torch.einsum("bt,btd->bd", w.to(dt), enc)
        return ctx, w


class RNNDecoder(nn.Module):
    """embed -> ``num_layers`` LSTM cells with location-aware attention ->
    output over [h, context]. Parameters fp32; ``dtype`` is the compute
    dtype."""

    def __init__(self, vocab_size: int, d_enc: int, units: int = 320,
                 num_layers: int = 1, emb_dim: int = 0, d_att: int = 320,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.units = vocab_size, units
        self.num_layers, self.dtype = num_layers, dtype
        d_emb = emb_dim or units
        self.embed = nn.Embedding(vocab_size, d_emb)
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTMLayer(
                d_emb + d_enc if i == 0 else units, units))
        self.att = LocationAttention(d_enc, units, d_att)
        self.output = Linear(units + d_enc, vocab_size)

    def precompute_memory(self, memory) -> Dict[str, torch.Tensor]:
        return {"enc": memory, "proj": self.att.precompute(memory)}

    def init_cache(self, batch: int, t_enc: int, memory_lengths=None,
                   device=None) -> Dict:
        device = device or self.output.weight.device
        z = lambda: torch.zeros(batch, self.units, device=device)
        cache = {f"layer_{i}": {"c": z(), "h": z()}
                 for i in range(self.num_layers)}
        if memory_lengths is not None:
            m = length_mask(memory_lengths.to(device), t_enc).float()
            cache["att_prev"] = m / m.sum(-1, keepdim=True).clamp_min(1.0)
        else:
            cache["att_prev"] = torch.full((batch, t_enc), 1.0 / t_enc,
                                           device=device)
        return cache

    def _step(self, y_emb, mem_kv, mask, cache):
        """One step from the embedded token y_emb [B, De] -> (logits [B,
        V], new cache, top hidden [B, P])."""
        enc = mem_kv["enc"]
        ctx, w = self.att(enc, mem_kv["proj"], mask, cache["layer_0"]["h"],
                          cache["att_prev"])
        x = torch.cat([y_emb, ctx], dim=-1)
        new = {}
        for i in range(self.num_layers):
            cell = getattr(self, f"lstm_{i}")
            st = cache[f"layer_{i}"]
            c, h = cell.cell(cell.project(x.to(self.dtype)),
                             (st["c"], st["h"]))
            new[f"layer_{i}"] = {"c": c, "h": h}
            x = h
        new["att_prev"] = w
        logits = self.output(torch.cat([x.to(self.dtype), ctx], dim=-1))
        return logits, new, x

    def step(self, y_t, step_idx: int, cache, mem_kv, memory_lengths,
             max_len: int, memory_mask: Optional[torch.Tensor] = None,
             return_hidden: bool = False):
        """One decode step, the TransformerDecoder.step contract: y_t [B]
        -> ([B, V] logits, new cache[, hidden [B, P]])."""
        enc = mem_kv["enc"]
        mask = (length_mask(memory_lengths.to(enc.device), enc.shape[1])
                if memory_mask is None else memory_mask)
        logits, new, h = self._step(self.embed(y_t).to(self.dtype), mem_kv,
                                    mask, cache)
        if return_hidden:
            return logits, new, h
        return logits, new

    def forward(self, ys_in, ys_lengths, memory, memory_lengths,
                memory_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False, causal: bool = True):
        """Teacher-forced: [B, U] ids -> [B, U, V] logits (and the hiddens
        [B, U, P] with ``return_hidden``). ``ys_lengths`` and ``causal``
        change nothing, as in the reference."""
        b, u = ys_in.shape
        t_enc = memory.shape[1]
        mem_kv = self.precompute_memory(memory)
        if memory_mask is None:
            memory_mask = length_mask(memory_lengths.to(memory.device), t_enc)
        cache = self.init_cache(b, t_enc, memory_lengths)
        embs = self.embed(ys_in).to(self.dtype)
        logits, hidden = [], []
        for i in range(u):
            out, cache, h = self._step(embs[:, i], mem_kv, memory_mask, cache)
            logits.append(out)
            hidden.append(h)
        logits = torch.stack(logits, 1)
        if return_hidden:
            return logits, torch.stack(hidden, 1)
        return logits
