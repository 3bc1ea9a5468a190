"""Streaming (block-online) inference by re-encoding.

Port of espnet_slurp_tpu/decode/streaming.py: ``StreamingRecognizer`` and
``StreamingTransducerRecognizer``.

A chunk-attention encoder with causal convs (models/conformer.py
``chunk_size`` / ``left_chunks``) gives the past frames the same states
whether it runs over a prefix or the whole utterance, so each call here
re-encodes the buffered audio, padded to ``bucket_length(n,
chunk_samples)`` (a few shapes a stream), and emits a partial hypothesis;
the final pass runs at ``is_final``. decode/incremental.py is the
constant-cost form of the same encode. The encode runs the model's
kernels on the card (K2, K3 with the chunk masks, K6 with ``fused_conv``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.sampler import bucket_length
from ..models.transducer import transducer_greedy_decode
from ..ops.ctc import collapse_repeats
from ..ops.normalize import mvn_tensors
from .incremental import final_decode, ids_text
from .transducer_beam import SEARCHES, run_search


class _Buffered:
    """The audio buffer and the padded re-encode both recognizers share."""

    def __init__(self, model, tokenizer, converter, chunk_samples, max_len,
                 beam_size, mvn_stats):
        self.model = model
        self.tokenizer, self.converter = tokenizer, converter
        self.chunk_samples = chunk_samples
        self.max_len, self.beam_size = max_len, beam_size
        self.mvn_stats = mvn_tensors(mvn_stats, model.device)
        self.reset()

    def reset(self) -> None:
        self._buffer = np.zeros((0,), np.float32)

    def _encode(self, speech_chunk, is_final: bool):
        """Appends the chunk; (hs [1, T', D], h_lengths [1]) of the whole
        buffer, or None while it is shorter than a chunk."""
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(speech_chunk, np.float32)])
        n = len(self._buffer)
        if n < self.chunk_samples and not is_final:
            return None
        pad_to = bucket_length(max(n, self.chunk_samples), self.chunk_samples)
        speech = np.zeros((1, pad_to), np.float32)
        speech[0, :n] = self._buffer
        dev = self.model.device
        return self.model.encode(torch.from_numpy(speech).to(dev),
                                 torch.full((1,), n, dtype=torch.long,
                                            device=dev), self.mvn_stats)

    def text(self, ids: List[int]) -> str:
        return ids_text(self.tokenizer, self.converter, ids)


class StreamingRecognizer(_Buffered):
    """Incremental speech -> text over a chunk-attention ASRModel:
    ``__call__(chunk, is_final) -> (token ids so far, done)``. Partials
    are CTC greedy; the final pass is the joint CTC / attention beam
    (``beam_size > 1``, at ``ctc_weight``) or attention greedy."""

    def __init__(self, model, tokenizer=None, converter=None,
                 chunk_samples: int = 8192, max_len: int = 128,
                 beam_size: int = 1, ctc_weight: float = 0.3,
                 mvn_stats=None):
        if model.cfg.chunk_size <= 0:
            raise ValueError("streaming needs a chunk-attention model "
                             "(cfg.chunk_size > 0)")
        self.ctc_weight = ctc_weight
        super().__init__(model, tokenizer, converter, chunk_samples, max_len,
                         beam_size, mvn_stats)

    @torch.inference_mode()
    def __call__(self, speech_chunk: np.ndarray, is_final: bool = False
                 ) -> Tuple[List[int], bool]:
        enc = self._encode(speech_chunk, is_final)
        if enc is None:
            return [], False
        hs, h_lengths = enc
        if not is_final:
            ids = self.model.ctc_logprobs(hs).argmax(-1)[0]
            return collapse_repeats(ids[:int(h_lengths[0])].tolist(),
                                    self.model.cfg.blank_id), False
        ids = final_decode(self.model, hs, h_lengths, self.beam_size,
                           self.max_len, self.ctc_weight)
        self.reset()
        return ids, True


class StreamingTransducerRecognizer(_Buffered):
    """Incremental transducer decode over a chunk-attention encoder
    (``cfg.asr.chunk_size > 0``): partials by the frame-synchronous greedy
    decode, the final pass by ``search`` (decode/transducer_beam.py:
    run_search; greedy when ``beam_size <= 1``)."""

    def __init__(self, model, tokenizer=None, converter=None,
                 chunk_samples: int = 8192, max_len: int = 128,
                 beam_size: int = 1, search: str = "alsa", mvn_stats=None):
        if model.cfg.asr.chunk_size <= 0:
            raise ValueError("the streaming transducer needs "
                             "cfg.asr.chunk_size > 0")
        if search not in SEARCHES:
            raise ValueError(f"search {search!r}: one of {SEARCHES}")
        self.search = search
        super().__init__(model, tokenizer, converter, chunk_samples, max_len,
                         beam_size, mvn_stats)

    @torch.inference_mode()
    def __call__(self, speech_chunk: np.ndarray, is_final: bool = False
                 ) -> Tuple[List[int], bool]:
        enc = self._encode(speech_chunk, is_final)
        if enc is None:
            return [], False
        hs, h_lengths = enc
        if not is_final:
            tokens, lengths = transducer_greedy_decode(
                self.model, hs, h_lengths, max_len=self.max_len)
            return tokens[0, :int(lengths[0])].tolist(), False
        tokens, lengths = run_search(self.model, hs, h_lengths, self.search,
                                     self.beam_size, self.max_len)
        self.reset()
        return tokens[0, :int(lengths[0])].tolist(), True
