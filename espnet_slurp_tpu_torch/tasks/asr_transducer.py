"""Transducer inference wrapper: waveforms in, text out.

Port of espnet_slurp_tpu/tasks/asr_transducer.py:Speech2TextTransducer,
greedy decoding only. Like the port's Speech2Text it is built from a
config, a state_dict and a token list (loading an experiment directory comes
with the port's checkpoints), and pads as the reference does
(tasks/asr.py:pad_speech_batch; one utterance is padded to
bucket_length(len, 4096), as the reference's ``__call__`` pads it). The
transducer beam searches (ALSA, default, mAES, TSD, NSC) are not ported yet:
``beam_size > 1`` raises.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.tokenizer import TokenIDConverter, build_tokenizer
from ..models.transducer import (TransducerConfig, TransducerModel,
                                 transducer_greedy_decode)
from .asr import pad_speech_batch


class Speech2TextTransducer:
    """Batched time-synchronous greedy transducer decoding."""

    def __init__(self, cfg: TransducerConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 token_list: Sequence[str], token_type: str = "char",
                 bpemodel: Optional[str] = None, max_len: int = 128,
                 beam_size: int = 1, speech_bucket_multiple: int = 4096,
                 device=None):
        if beam_size > 1:
            raise NotImplementedError(
                "Speech2TextTransducer: the transducer beam searches are not "
                "ported yet; use beam_size=1 (greedy)")
        self.model = TransducerModel(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.tokenizer = build_tokenizer(token_type, bpemodel)
        self.converter = TokenIDConverter(list(token_list))
        self.max_len = max_len
        self.speech_bucket_multiple = speech_bucket_multiple

    def __call__(self, speech: np.ndarray) -> str:
        """Single utterance: [N] float waveform -> text."""
        return self.decode_batch([speech])[0]

    def pad_batch(self, speeches: Sequence[np.ndarray]):
        return pad_speech_batch(speeches, self.speech_bucket_multiple)

    @torch.inference_mode()
    def decode_batch(self, speeches: Sequence[np.ndarray]) -> List[str]:
        """List of [N_i] waveforms -> list of texts, in one batched decode."""
        buf, lens = self.pad_batch(speeches)
        dev = self.model.device
        hs, h_lengths = self.model.encode(torch.from_numpy(buf).to(dev),
                                          torch.from_numpy(lens).to(dev))
        tokens, lengths = transducer_greedy_decode(self.model, hs, h_lengths,
                                                   max_len=self.max_len)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [self.tokenizer.tokens2text(
                    self.converter.ids2tokens(tokens[i, :lengths[i]]))
                for i in range(len(speeches))]
