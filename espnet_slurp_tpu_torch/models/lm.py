"""Language models: Transformer LM and recurrent (LSTM) LM.

Port of espnet_slurp_tpu/models/lm.py (``LMConfig``, ``TransformerLM``,
``LSTMLM``, ``lm_loss``). Parameters are fp32 and the layers compute in
``cfg.dtype``, as the flax modules do; module names follow the flax tree
(``embed``, ``attn_{i}``, ``norm{1,2}_{i}``, ``ff_{i}``, ``after_norm``,
``output``, ``rnn_{i}``), so utils/params.py:flax_to_torch converts a
reference LM's parameters to a state_dict that loads strictly.

Both LMs have a stateful ``step`` for shallow fusion in the beam search.
The Transformer's step cache is {"pos": [B], "layer_{i}": {"k", "v"}} with
[B, max_len, H, Dh] tensors; every hypothesis advances in lockstep, so the
position is ``pos[0]``, read on the device (no host sync). ``step`` is a
pure function: it returns new cache tensors and leaves the old ones as they
were, because the word-level fusions (decode/word_lm.py) keep the old state
of the hypotheses that are not at a word boundary.

The LSTM's carry is a list of (c, h) per layer, fp32 in both dtypes (as the
transducer's prediction network keeps it; ROADMAP.md queue 3). Neither LM
applies dropout: the reference's ``CachedAttention`` and Transformer
``FeedForward`` ignore ``dropout_rate`` (queue 3), and so does its LSTM LM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.masks import attention_bias, causal_mask, length_mask
from ..utils.device import resolve_device
from .conformer import LN_EPS
from .embedding import abs_positional_encoding, sinusoid_table
from .layers import LSTMLayer, LayerNorm, Linear
from .transformer import CachedAttention, FeedForward

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 5000
    arch: str = "transformer"  # transformer | lstm
    d_model: int = 512
    n_head: int = 8
    d_ff: int = 2048
    num_blocks: int = 16
    num_layers: int = 2       # lstm
    dropout_rate: float = 0.0
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class TransformerLM(nn.Module):
    """Pre-norm causal Transformer over tokens: [B, L] -> [B, L, V]."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.embed = nn.Embedding(c.vocab_size, c.d_model)
        for i in range(c.num_blocks):
            self.add_module(f"attn_{i}", CachedAttention(c.n_head, c.d_model))
            self.add_module(f"norm1_{i}", LayerNorm(c.d_model, eps=LN_EPS))
            self.add_module(f"norm2_{i}", LayerNorm(c.d_model, eps=LN_EPS))
            self.add_module(f"ff_{i}", FeedForward(c.d_model, c.d_ff))
        self.after_norm = LayerNorm(c.d_model, eps=LN_EPS)
        self.output = Linear(c.d_model, c.vocab_size)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    def _block(self, i: int, name: str) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def forward(self, ys: torch.Tensor, ys_lengths: torch.Tensor
                ) -> torch.Tensor:
        """[B, L] -> [B, L, V] next-token logits (causal & length mask)."""
        l = ys.shape[1]
        x = abs_positional_encoding(self.embed(ys).to(self.cfg.torch_dtype),
                                    scale=True)
        bias = attention_bias(causal_mask(l, ys.device)[None, None]
                              & length_mask(ys_lengths, l)[:, None, None, :])
        for i in range(self.cfg.num_blocks):
            h = self._block(i, "norm1")(x)
            x = x + self._block(i, "attn")(h, h, bias)
            x = x + self._block(i, "ff")(self._block(i, "norm2")(x))
        return self.output(self.after_norm(x))

    def init_cache(self, batch: int, max_len: int) -> Dict:
        c = self.cfg
        dh = c.d_model // c.n_head
        z = lambda: torch.zeros(batch, max_len, c.n_head, dh,
                                dtype=c.torch_dtype, device=self.device)
        return {"pos": torch.zeros(batch, dtype=torch.long,
                                   device=self.device),
                **{f"layer_{i}": {"k": z(), "v": z()}
                   for i in range(c.num_blocks)}}

    def step(self, y_t: torch.Tensor, cache: Dict
             ) -> Tuple[torch.Tensor, Dict]:
        """One token: [B] -> ([B, V] logits, new cache)."""
        c = self.cfg
        max_len = cache["layer_0"]["k"].shape[1]
        pos = cache["pos"][:1]  # [1]: every hypothesis is at the same step
        emb = self.embed(y_t[:, None]).to(c.torch_dtype) * math.sqrt(
            c.d_model)
        pe = torch.from_numpy(sinusoid_table(max_len, c.d_model)).to(
            emb.device)
        x = emb + pe.index_select(0, pos)[None].to(emb.dtype)
        poss = torch.arange(max_len, device=y_t.device)
        bias = torch.where(poss <= pos, 0.0, -1e9).to(
            torch.float32)[None, None, None, :]
        new_cache = {"pos": cache["pos"] + 1}
        for i in range(c.num_blocks):
            attn = self._block(i, "attn")
            h = self._block(i, "norm1")(x)
            k_t, v_t = attn.project_kv(h)
            ck = cache[f"layer_{i}"]["k"].index_copy(1, pos, k_t)
            cv = cache[f"layer_{i}"]["v"].index_copy(1, pos, v_t)
            x = x + attn.attend(h, ck, cv, bias)
            x = x + self._block(i, "ff")(self._block(i, "norm2")(x))
            new_cache[f"layer_{i}"] = {"k": ck, "v": cv}
        return self.output(self.after_norm(x))[:, 0], new_cache


Carry = List[Tuple[torch.Tensor, torch.Tensor]]


class LSTMLM(nn.Module):
    """Embedding, ``num_layers`` LSTM layers of width d_model (flax's
    OptimizedLSTMCell), output projection (espnet2 SequentialRNNLM)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.num_layers):
            self.add_module(f"rnn_{i}", LSTMLayer(cfg.d_model, cfg.d_model))
        self.output = Linear(cfg.d_model, cfg.vocab_size)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    def _rnns(self) -> List[LSTMLayer]:
        return [getattr(self, f"rnn_{i}") for i in range(self.cfg.num_layers)]

    def init_carry(self, batch: int) -> Carry:
        z = lambda: torch.zeros(batch, self.cfg.d_model, device=self.device)
        return [(z(), z()) for _ in range(self.cfg.num_layers)]

    def step(self, y_t: torch.Tensor, carry: Carry
             ) -> Tuple[torch.Tensor, Carry]:
        """One token: [B] -> ([B, V] logits, new carry)."""
        dt = self.cfg.torch_dtype
        x = self.embed(y_t).to(dt)
        new = []
        for rnn, cr in zip(self._rnns(), carry):
            cr = rnn.cell(rnn.project(x.to(dt)), cr)
            new.append(cr)
            x = cr[1]
        return self.output(x.to(dt)), new

    def forward(self, ys: torch.Tensor, ys_lengths: Optional[torch.Tensor]
                = None) -> torch.Tensor:
        """[B, L] -> [B, L, V]; the scan starts from a zero carry and runs
        over the padding too, as flax's nn.RNN does."""
        dt = self.cfg.torch_dtype
        x = self.embed(ys).to(dt)
        for rnn in self._rnns():
            x = rnn(x.to(dt))
        return self.output(x.to(dt))


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            lengths: torch.Tensor):
    """Next-token NLL, mean over valid tokens: (loss, ppl, ntokens)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets[..., None].long())[..., 0]
    mask = length_mask(lengths, targets.shape[1])
    total = torch.where(mask, nll, torch.zeros_like(nll)).sum()
    n = mask.sum().clamp_min(1)
    mean = total / n
    return mean, torch.exp(mean), n
