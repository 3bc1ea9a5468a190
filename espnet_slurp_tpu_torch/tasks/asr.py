"""Inference wrapper: waveforms in, text out.

Port of espnet_slurp_tpu/tasks/asr.py:Speech2Text (``decode_batch`` and
``__call__``). It is built from an ``ASRConfig``, a state_dict and a token
list; loading an experiment directory and the CLI come with the training
slice, which writes the port's own checkpoints.

Padding follows the reference exactly, because the STFT reflect-pads the
padded [B, N] buffer and the padded length therefore changes the last frames
of shorter utterances: the batch is padded to a power of two (padding rows
get length 1) and the samples to ``bucket_length(max_len, 4096)``.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.sampler import bucket_length
from ..data.tokenizer import TokenIDConverter, build_tokenizer
from ..decode.beam import BeamSearchConfig, batch_beam_search
from ..decode.greedy import attention_greedy_decode
from ..models.asr_model import ASRConfig, ASRModel


def pad_speech_batch(speeches: Sequence[np.ndarray], multiple: int = 4096):
    """(buf [bb, n] float32, lens [bb] int32) padded as the reference pads:
    bb the next power of two (padding rows get length 1), n =
    bucket_length(longest, multiple)."""
    b = len(speeches)
    bb = 1
    while bb < b:
        bb *= 2
    n = bucket_length(max(len(s) for s in speeches), multiple)
    buf = np.zeros((bb, n), np.float32)
    lens = np.ones((bb,), np.int32)
    for i, s in enumerate(speeches):
        buf[i, :len(s)] = s
        lens[i] = len(s)
    return buf, lens


class Speech2Text:
    """Batched ASR decoding with the attention decoder (greedy when
    ``beam_size <= 1``) or joint CTC/attention beam search."""

    def __init__(self, cfg: ASRConfig, state_dict: Mapping[str, torch.Tensor],
                 token_list: Sequence[str], token_type: str = "char",
                 bpemodel: Optional[str] = None, max_len: int = 128,
                 beam_size: int = 1, ctc_weight: float = 0.0,
                 speech_bucket_multiple: int = 4096, device=None):
        self.model = ASRModel(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.tokenizer = build_tokenizer(token_type, bpemodel)
        self.converter = TokenIDConverter(list(token_list))
        self.max_len = max_len
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.speech_bucket_multiple = speech_bucket_multiple

    def __call__(self, speech: np.ndarray) -> str:
        """Single utterance: [N] float waveform -> text."""
        return self.decode_batch([speech])[0]

    def pad_batch(self, speeches: Sequence[np.ndarray]):
        """(buf [bb, n] float32, lens [bb] int32): ``pad_speech_batch``."""
        return pad_speech_batch(speeches, self.speech_bucket_multiple)

    @torch.inference_mode()
    def decode_batch(self, speeches: Sequence[np.ndarray]) -> List[str]:
        """List of [N_i] waveforms -> list of texts, in one batched search."""
        buf, lens = self.pad_batch(speeches)
        dev = self.model.device
        hs, h_lengths = self.model.encode(torch.from_numpy(buf).to(dev),
                                          torch.from_numpy(lens).to(dev))
        if self.beam_size <= 1:
            tokens, lengths = attention_greedy_decode(
                self.model, hs, h_lengths, self.max_len)
        else:
            tokens, lengths = batch_beam_search(
                self.model, hs, h_lengths,
                BeamSearchConfig(beam_size=self.beam_size,
                                 max_len=self.max_len,
                                 ctc_weight=self.ctc_weight))
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [self.tokenizer.tokens2text(
                    self.converter.ids2tokens(tokens[i, :lengths[i]]))
                for i in range(len(speeches))]
