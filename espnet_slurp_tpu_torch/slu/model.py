"""SLU model: hybrid CTC/attention over intent+entity token targets, with
optional two-pass transcript fusion.

Port of espnet_slurp_tpu/slu/model.py: ``SLUConfig``, ``TextEncoder``,
``BertPostdecoder``, ``DeliberationEncoder`` and ``SLUModel`` with
``encode`` and the training loss (``forward``). The second pass encodes
the transcript (a Transformer text encoder or an HF-architecture BERT,
models/hf_transformer.py), concatenates it after the acoustic memory
*padded* on each side, with the combined mask ``a_mask ++ t_mask``, and
optionally runs Conformer deliberation blocks over the fused memory; the
shared attention decoder reads it through that mask.

Kernels: the acoustic encoder is the ASR model's (K2 and K3 on its
blocks). The fused memory's mask has a hole between the two streams, and
K3 masks keys by a length prefix only, so the deliberation blocks are
built eager (``use_flash=False``: masked attention, the conv module's pad
mask zeroing the hole before the depthwise conv, the eager FFNs), as the
reference's are (it builds them without flash and passes no lengths). CTC
attaches to the acoustic states before fusion through the shared head's
logits (ops/ctc.py:ctc_loss_mean_logits: kernel K1, no K4), as the
reference's loss does.

The reference's ASR model creates no TCPGen parameters in an SLU model
even under ``use_tcpgen`` (its SLU losses never call TCPGen), so the ASR
model here is built with ``use_tcpgen`` off (ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..models.asr_model import (ASRConfig, ASRModel, add_sos_eos,
                                label_smoothing_loss)
from ..models.attention import MultiHeadAttention
from ..models.conformer import LN_EPS, ConformerBlock
from ..models.embedding import (abs_positional_encoding,
                                rel_positional_embedding)
from ..models.hf_transformer import BertConfig, BertModel, bert_config_from_dir
from ..models.layers import LayerNorm, Linear
from ..ops.ctc import ctc_loss_mean_logits
from ..ops.masks import attention_bias, length_mask
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SLUConfig:
    asr: ASRConfig = ASRConfig()
    two_pass: bool = False
    transcript_vocab_size: int = 0          # set by the task from vocab
    text_encoder_blocks: int = 4
    text_encoder_d_ff: int = 1024
    deliberation_blocks: int = 0            # conformer blocks over fused memory
    deliberation_d_ff: int = 1024
    # "transformer" (a text encoder trained from scratch) | "bert" (an
    # HF-architecture BERT, whose weights can come from a local HF model
    # directory, postdecoder_hf_dir).
    postdecoder: str = "transformer"
    postdecoder_hf_dir: Optional[str] = None


def _masked(x, mask):
    return torch.where(mask[..., None], x, torch.zeros_like(x))


class TextEncoder(nn.Module):
    """Pre-norm Transformer encoder over transcript tokens (embedding, abs
    positions, MHSA and a tanh-GELU FFN a block, after_norm): forward(tokens,
    lengths) -> (states [B, L, D] with padding zeroed, mask [B, L])."""

    def __init__(self, vocab_size: int, d_model: int, n_head: int,
                 d_ff: int, num_blocks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks, self.dtype = num_blocks, dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_blocks):
            self.add_module(f"norm1_{i}", LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"attn_{i}", MultiHeadAttention(n_head, d_model))
            self.add_module(f"norm2_{i}", LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"ff1_{i}", Linear(d_model, d_ff))
            self.add_module(f"ff2_{i}", Linear(d_ff, d_model))
        self.after_norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tokens, lengths):
        x = abs_positional_encoding(self.embed(tokens.long()).to(self.dtype),
                                    scale=True)
        mask = length_mask(lengths.to(tokens.device), tokens.shape[1])
        bias = attention_bias(mask[:, None, None, :])
        for i in range(self.num_blocks):
            m = lambda name: getattr(self, f"{name}_{i}")
            h = m("norm1")(x)
            x = x + m("attn")(h, h, h, bias)
            h = m("ff1")(m("norm2")(x))
            x = x + m("ff2")(torch.nn.functional.gelu(h, approximate="tanh"))
        return _masked(self.after_norm(x), mask), mask


class BertPostdecoder(nn.Module):
    """HF-architecture BERT over the transcript and a linear projection to
    d_model (the reference's hugging_face_transformers_postdecoder.py:
    model(**encoded) -> linear_out). With ``hf_dir`` the BERT takes that
    directory's config.json; its weights are grafted by
    tasks/slu.py:SLUTask.load_postdecoder_weights."""

    def __init__(self, vocab_size: int, d_model: int,
                 hf_dir: Optional[str] = None, n_head: int = 4,
                 d_ff: int = 1024, num_blocks: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if hf_dir:
            bcfg = bert_config_from_dir(hf_dir)
        else:
            bcfg = BertConfig(
                vocab_size=vocab_size, hidden_size=d_model,
                num_hidden_layers=num_blocks, num_attention_heads=n_head,
                intermediate_size=d_ff, max_position_embeddings=512)
        self.bert = BertModel(bcfg, dtype=dtype)
        self.linear_out = Linear(bcfg.hidden_size, d_model)

    def forward(self, tokens, lengths):
        mask = length_mask(lengths.to(tokens.device), tokens.shape[1])
        hs = self.linear_out(self.bert(tokens, mask.int()))
        return _masked(hs, mask), mask


class DeliberationEncoder(nn.Module):
    """Conformer blocks (kernel 15, no dropout, eager) over the fused memory
    and its mask with a hole: forward(x [B, T, D], mask [B, T]) -> states
    with the masked positions zeroed."""

    def __init__(self, d_model: int, n_head: int, d_ff: int,
                 num_blocks: int, kernel_size: int = 15):
        super().__init__()
        self.d_model, self.num_blocks = d_model, num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, n_head, d_ff, kernel_size, use_flash=False))

    def forward(self, x, mask):
        pos_emb = rel_positional_embedding(x.shape[1], self.d_model, x.dtype,
                                           x.device)
        bias = attention_bias(mask[:, None, None, :])
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, bias, mask)
        return _masked(x, mask)


class SLUModel(nn.Module):
    """Speech -> intent+entity token sequence, optionally fused with a
    transcript second stream (two-pass); built on ``device`` (the card
    unless ``device="cpu"``) with fp32 parameters, computing in
    ``cfg.asr.dtype``."""

    def __init__(self, cfg: SLUConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        dev = resolve_device(device)
        self.asr = ASRModel(dataclasses.replace(c.asr, use_tcpgen=False),
                            device=dev)
        dtype = c.asr.torch_dtype
        if c.two_pass:
            if c.postdecoder == "bert":
                self.text_encoder = BertPostdecoder(
                    c.transcript_vocab_size, c.asr.d_model,
                    hf_dir=c.postdecoder_hf_dir, n_head=c.asr.n_head,
                    d_ff=c.text_encoder_d_ff,
                    num_blocks=c.text_encoder_blocks, dtype=dtype)
            else:
                self.text_encoder = TextEncoder(
                    c.transcript_vocab_size, c.asr.d_model, c.asr.n_head,
                    c.text_encoder_d_ff, c.text_encoder_blocks, dtype=dtype)
            if c.deliberation_blocks > 0:
                self.deliberation = DeliberationEncoder(
                    c.asr.d_model, c.asr.n_head, c.deliberation_d_ff,
                    c.deliberation_blocks)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.asr.device

    def _fuse(self, hs, a_mask, transcript, transcript_lengths):
        ts, t_mask = self.text_encoder(transcript.clamp_min(0),
                                       transcript_lengths)
        memory = torch.cat([hs, ts.to(hs.dtype)], dim=1)
        mask = torch.cat([a_mask, t_mask], dim=1)
        if self.cfg.deliberation_blocks > 0:
            memory = self.deliberation(memory, mask)
        return memory, mask

    def _acoustic(self, speech, speech_lengths, train, generator, mvn_stats):
        hs, h_lengths = self.asr.encode(speech, speech_lengths, mvn_stats,
                                        train=train, generator=generator)
        return hs, h_lengths, length_mask(h_lengths, hs.shape[1])

    def encode(self, speech, speech_lengths, transcript=None,
               transcript_lengths=None, *, train: bool = False,
               generator: Optional[torch.Generator] = None, mvn_stats=None):
        """-> (memory [B, T' (+ L), D], memory_mask): the acoustic states,
        or with ``two_pass`` and a transcript the fused memory."""
        hs, _, a_mask = self._acoustic(speech, speech_lengths, train,
                                       generator, mvn_stats)
        if not self.cfg.two_pass or transcript is None:
            return hs, a_mask
        return self._fuse(hs, a_mask, transcript, transcript_lengths)

    def forward(self, speech, speech_lengths, text, text_lengths,
                transcript=None, transcript_lengths=None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None, mvn_stats=None):
        """Training forward -> (loss, stats with loss_ctc, loss_att, acc,
        loss): ctc_weight x CTC on the acoustic states + (1 - ctc_weight) x
        the label-smoothed CE of the decoder over the (fused) memory.
        ``generator`` draws SpecAug's masks and the acoustic encoder's
        dropout when ``train``."""
        c = self.cfg.asr
        hs, h_lengths, a_mask = self._acoustic(speech, speech_lengths, train,
                                               generator, mvn_stats)
        if self.cfg.two_pass and transcript is not None:
            memory, mem_mask = self._fuse(hs, a_mask, transcript,
                                          transcript_lengths)
        else:
            memory, mem_mask = hs, a_mask
        stats: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=hs.device)
        if c.ctc_weight > 0.0:
            loss_ctc = ctc_loss_mean_logits(
                self.asr.ctc_proj(hs), h_lengths, text.clamp_min(0),
                text_lengths, c.blank_id)
            stats["loss_ctc"] = loss_ctc
            loss = loss + c.ctc_weight * loss_ctc
        if c.ctc_weight < 1.0:
            text_lengths = text_lengths.to(text.device)
            ys_in, ys_out = add_sos_eos(text.clamp_min(0).long(),
                                        text_lengths, c.sos_id, c.eos_id)
            logits = self.asr.decoder(ys_in, text_lengths + 1, memory, None,
                                      memory_mask=mem_mask)
            loss_att, acc = label_smoothing_loss(logits, ys_out, c.lsm_weight)
            stats["loss_att"] = loss_att
            stats["acc"] = acc
            loss = loss + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats
