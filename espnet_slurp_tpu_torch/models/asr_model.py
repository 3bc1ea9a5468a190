"""Hybrid CTC/attention ASR model, inference half.

Port of espnet_slurp_tpu/models/asr_model.py: ``ASRConfig`` (the fields
this slice uses, with the reference's defaults) and ``ASRModel`` with
``encode`` (frontend -> MVN -> Conformer), ``ctc_logprobs`` and
``decoder_logits``. The losses come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.frontend import FrontendConfig, default_frontend
from ..ops.normalize import global_mvn, utterance_mvn
from ..utils.device import resolve_device
from .conformer import ConformerEncoder
from .transformer import TransformerDecoder


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    vocab_size: int = 5000
    d_model: int = 256
    n_head: int = 4
    d_ff: int = 2048
    num_encoder_blocks: int = 12
    num_decoder_blocks: int = 6
    decoder_d_ff: int = 2048
    kernel_size: int = 31
    blank_id: int = 0
    sos: int = -1  # -1 => vocab_size - 1
    eos: int = -1
    use_mvn: str = "utterance"  # "global" | "utterance" | "none"
    chunk_size: int = 0  # > 0: streaming chunk attention (frames after x4)
    left_chunks: int = -1
    flash_attention: str = "auto"  # "auto"/"on": kernels K2/K3; "off": eager
    subsampling_factor: int = 4
    frontend: FrontendConfig = FrontendConfig()
    dtype: str = "float32"  # compute dtype: float32 | bfloat16

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1 if self.sos < 0 else self.sos

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1 if self.eos < 0 else self.eos


def flagship_config() -> ASRConfig:
    """The flagship LS-100 Conformer (__graft_entry__.py:25-27): vocab 5000,
    12 x 256 encoder, 4 heads, d_ff 1024, kernel 31, 6-block decoder with
    d_ff 2048, bf16."""
    return ASRConfig(vocab_size=5000, d_model=256, n_head=4, d_ff=1024,
                     num_encoder_blocks=12, num_decoder_blocks=6,
                     decoder_d_ff=2048, kernel_size=31, dtype="bfloat16")


class ASRModel(nn.Module):
    """Encoder + CTC head + attention decoder, built on ``device`` (the card
    unless ``device="cpu"``) in ``cfg.dtype``. The frontend runs in fp32."""

    def __init__(self, cfg: ASRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.encoder = ConformerEncoder(
            c.frontend.n_mels, c.d_model, c.n_head, c.d_ff,
            c.num_encoder_blocks, c.kernel_size, chunk_size=c.chunk_size,
            left_chunks=c.left_chunks, flash=c.flash_attention,
            subsampling_factor=c.subsampling_factor)
        self.ctc_proj = nn.Linear(c.d_model, c.vocab_size)
        self.decoder = TransformerDecoder(c.vocab_size, c.d_model, c.n_head,
                                          c.decoder_d_ff, c.num_decoder_blocks)
        self.to(device=resolve_device(device), dtype=c.torch_dtype)

    @property
    def device(self) -> torch.device:
        return self.ctc_proj.weight.device

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               mvn_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw waveform [B, N] -> (hs [B, T', D], h_lengths [B])."""
        c = self.cfg
        feats, feat_lengths = default_frontend(speech, speech_lengths,
                                               c.frontend)
        if c.use_mvn == "global" and mvn_stats is not None:
            feats = global_mvn(feats, feat_lengths, *mvn_stats)
        elif c.use_mvn == "utterance":
            feats = utterance_mvn(feats, feat_lengths)
        return self.encoder(feats.to(c.torch_dtype), feat_lengths)

    def ctc_logprobs(self, hs: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc_proj(hs).float(), dim=-1)

    def decoder_logits(self, ys_in, ys_in_lengths, hs, h_lengths):
        return self.decoder(ys_in, ys_in_lengths, hs, h_lengths)
