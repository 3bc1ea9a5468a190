"""Batched greedy attention decoding. Port of espnet_slurp_tpu/decode/greedy.py
(the beam-size-1 path): [B] hypotheses advance in lockstep, finished ones
freeze at eos, and the loop stops once all have ended: one host sync a
step, counted in utils/device.py:host_syncs. A ``memory_mask`` decodes
over a memory that is not a length prefix (the SLU fused memory,
tasks/slu.py:_greedy_over_memory)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.asr_model import ASRModel
from ..models.rnn_decoder import RNNDecoder
from ..utils.device import host_bool


def init_decoder_cache(model: ASRModel, batch: int, max_len: int,
                       t_enc: int = 0, memory_lengths=None):
    """The decoder's initial cache: the Transformer decoder's zeroed
    self-attention KV cache (or a conv decoder's GLU rings) for
    ``max_len`` steps; the LAS decoder's zero LSTM states and its first
    attention weights, uniform over the first memory_lengths of ``t_enc``
    frames (over all of them without ``memory_lengths``)."""
    if isinstance(model.decoder, RNNDecoder):
        return model.decoder.init_cache(batch, t_enc, memory_lengths)
    return model.decoder.init_cache(batch, max_len)


def eos_lengths(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """Length of each row's prefix before its first eos (last axis)."""
    return torch.cumprod((tokens != eos).long(), dim=-1).sum(dim=-1)


@torch.inference_mode()
def attention_greedy_decode(model: ASRModel, hs: torch.Tensor,
                            h_lengths: torch.Tensor, max_len: int = 128,
                            memory_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, max_len] eos-padded, lengths [B] without sos/eos).
    The decoder reads ``hs`` through ``memory_mask`` [B, T] when given,
    else through ``h_lengths``."""
    cfg = model.cfg
    b = hs.shape[0]
    sos, eos = cfg.sos_id, cfg.eos_id
    mem_kv = model.decoder.precompute_memory(hs)
    cache = init_decoder_cache(model, b, max_len, hs.shape[1], h_lengths)
    tokens = torch.full((b, max_len), eos, dtype=torch.long, device=hs.device)
    y = torch.full((b,), sos, dtype=torch.long, device=hs.device)
    ended = torch.zeros(b, dtype=torch.bool, device=hs.device)
    for i in range(max_len):
        logits, cache = model.decoder.step(y, i, cache, mem_kv, h_lengths,
                                           max_len, memory_mask=memory_mask)
        y = torch.where(ended, eos, logits.argmax(dim=-1))
        tokens[:, i] = y
        ended = ended | (y == eos)
        if host_bool(ended.all()):
            break
    return tokens, eos_lengths(tokens, eos)
