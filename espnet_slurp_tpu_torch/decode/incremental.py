"""O(1)-state incremental streaming encoder (exact, per-layer caches).

Port of espnet_slurp_tpu/decode/incremental.py: ``IncrementalConformerEncoder``
(the reference's ``_IncrementalStep`` is its ``_step``) and
``IncrementalRecognizer``.

The re-encoding StreamingRecognizer (decode/streaming.py) encodes the whole
audio prefix each chunk, O(T^2) over a stream. Here each step costs the
same whatever the stream's length, and its frames are those of the full
chunk-attention encode up to float reassociation:

- Chunked attention (chunk S frames, ``left_chunks`` L) composes across
  depth, so each layer caches its own INPUT frames: at most C = (L +
  ceil((k - 1) / S)) * S of them (the attention's left context and the
  causal conv's halo), and each step runs the model's own ConformerBlock
  over [cache | new chunk] and keeps its last S output frames.
- The frontend is streamed sample-exactly: the full STFT's reflect centre
  padding is made on the host once enough samples arrived, and each step
  takes a fixed ((4S + 2) hop + n_fft)-sample slice: 4S + 3 mel frames
  (stft ``center=False`` -> log-mel -> global MVN) give exactly S frames
  of the x4 Conv2dSubsampling.

The reference runs the block over the full C + S window with a key-valid
mask (keys in [C - n_valid, C + n_new)) that kernel K3's key-length mask
cannot express, and so builds its blocks without the kernels. Here the
window is trimmed to [the n_valid valid cache frames | new], n_valid + S
frames with lengths n_valid + n_new, at the same (chunk, left_chunks):
n_valid grows in whole chunks, so the chunk grid moves by whole chunks, the
relative positions are unchanged and the causal conv's zero left pad is
the reference's zeroed invalid frames. The block then takes its kernels
(K2, K3, and K6 with ``fused_conv``) on the card, at one of C / S + 1
window widths. Unlike the reference's step, the encoder's ``after_norm``
is applied to the step's frames, as the full encode applies it
(ROADMAP.md queue 3: the reference leaves it out).

Constraints, as the reference's asserts (here ValueError): chunk_size > 0,
left_chunks >= 0, use_mvn none or global, a plain conformer (no MoE, no
pre- or post-encoder), no delta features; and what the step's arithmetic
assumes besides: the default log-mel frontend, the x4 conv2d input layer,
no self-conditioning.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.asr_model import ASRModel
from ..models.embedding import rel_positional_embedding
from ..ops.ctc import collapse_repeats
from ..ops.masks import attention_bias, chunk_mask, length_mask
from ..ops.mel import logmel
from ..ops.normalize import global_mvn, mvn_tensors
from ..ops.stft import stft


def check_incremental(cfg) -> None:
    """Raises ValueError when ``cfg`` (an ASRConfig) is no model the
    incremental encoder can stream."""
    fc = cfg.frontend
    bad = [why for why, ok in (
        ("chunk_size > 0 and left_chunks >= 0",
         cfg.chunk_size > 0 and cfg.left_chunks >= 0),
        ("use_mvn none or global (utterance MVN is not streamable)",
         cfg.use_mvn in ("none", "global")),
        ("encoder conformer", cfg.encoder == "conformer"),
        ("frontend delta_order 0", fc.delta_order == 0),
        ("no MoE, pre- or post-encoder (the plain conformer stack)",
         cfg.moe_experts == 0 and not cfg.preencoder
         and not cfg.postencoder),
        ("the default centred log-mel frontend",
         fc.type == "default" and fc.center),
        ("the x4 conv2d input layer",
         cfg.input_layer == "conv2d" and cfg.subsampling_factor == 4),
        ("no self-conditioning", not cfg.self_conditioning),
        ("no input_feats", not cfg.input_feats)) if not ok]
    if bad:
        raise ValueError("incremental streaming needs " + "; ".join(bad))


class IncrementalConformerEncoder:
    """Stateful exact streaming encoder over a chunk-attention ASRModel.

    ``feed(samples, is_final)`` -> the newly finalized encoder frames [n,
    D] on the model's device, in its compute dtype (after ``after_norm``).
    ``mvn_stats`` is a use_mvn: global model's (mean, inv_std)."""

    def __init__(self, model: ASRModel, mvn_stats=None):
        cfg = model.cfg
        check_incremental(cfg)
        fc = cfg.frontend
        self.model, self.cfg, self.fc = model, cfg, fc
        self.s = cfg.chunk_size
        halo_chunks = -(-(cfg.kernel_size - 1) // self.s)
        self.cache_len = (cfg.left_chunks + halo_chunks) * self.s
        self.hop, self.n_fft, self.pad = fc.hop_length, fc.n_fft, fc.n_fft // 2
        # samples consumed per step: (4S+3) mel frames at center=False
        self.mel_per_step = 4 * self.s + 3
        self.win_samples = (self.mel_per_step - 1) * self.hop + self.n_fft
        self.mvn_stats = mvn_tensors(mvn_stats, model.device)
        self._pos_emb = {}
        self.reset()

    def reset(self) -> None:
        self._n_raw = 0                          # total raw samples seen
        self._head = np.zeros((0,), np.float32)  # pre-pad accumulation
        self._raw_tail = np.zeros((0,), np.float32)  # for the end reflect
        # reflect-padded stream, trimmed to the unconsumed suffix:
        # _padded[i] is padded-stream sample (_pad_offset + i).
        self._padded = None
        self._pad_offset = 0
        self._mel_done = 0                       # mel frames consumed
        # each layer's valid input frames, at most cache_len of them
        self._caches: List[torch.Tensor] = [
            torch.zeros(1, 0, self.cfg.d_model, dtype=self.cfg.torch_dtype,
                        device=self.model.device)
            for _ in range(self.cfg.num_encoder_blocks)]

    @property
    def n_valid(self) -> int:
        return self._caches[0].shape[1]

    @torch.inference_mode()
    def _step(self, samples: np.ndarray, n_new: int) -> torch.Tensor:
        """One chunk: [win_samples] padded-stream samples -> the S frames
        of the last block (after_norm applied) [1, S, D]; the caches move
        on by S frames."""
        enc, fc, s = self.model.encoder, self.fc, self.s
        dev, dt = self.model.device, self.cfg.torch_dtype
        x = torch.from_numpy(samples).to(dev)[None]
        spec = stft(x, n_fft=fc.n_fft, win_length=fc.win_length,
                    hop_length=fc.hop_length, window=fc.window, center=False)
        power = spec[..., 0] ** 2 + spec[..., 1] ** 2
        mel = logmel(power, None, fs=fc.fs, n_fft=fc.n_fft, n_mels=fc.n_mels,
                     fmin=fc.fmin, fmax=fc.fmax, htk=fc.htk)
        if self.cfg.use_mvn == "global" and self.mvn_stats is not None:
            mel = global_mvn(mel, torch.full((1,), mel.shape[1], device=dev),
                             *self.mvn_stats)
        x = enc.embed(mel.to(dt)) * math.sqrt(self.cfg.d_model)  # [1, S, D]
        nv = self.n_valid
        w = nv + s
        lengths = torch.full((1,), nv + n_new, dtype=torch.int32, device=dev)
        pad = length_mask(lengths, w)
        if w not in self._pos_emb:  # at most C / S + 1 widths
            self._pos_emb[w] = rel_positional_embedding(w, self.cfg.d_model,
                                                        dt, dev)
        pos_emb = self._pos_emb[w]
        bias = None  # the kernel path masks lengths and chunks itself
        if not enc.use_flash:
            bias = attention_bias(pad[:, None, None, :] & chunk_mask(
                w, s, self.cfg.left_chunks, dev)[None, None])
        for i in range(self.cfg.num_encoder_blocks):
            win = torch.cat([self._caches[i], x], dim=1)
            out = getattr(enc, f"block_{i}")(win, pos_emb, bias, pad, lengths)
            self._caches[i] = win[:, -self.cache_len:] if self.cache_len \
                else win[:, :0]
            x = out[:, -s:]
        return enc.after_norm(x)

    def feed(self, samples: np.ndarray, is_final: bool = False
             ) -> torch.Tensor:
        """Returns the newly finalized encoder frames [n, D] (may be
        empty). Host state is O(1) in stream length: the consumed prefix
        of the reflect-padded stream is dropped after each step, and only
        a (pad + 2)-sample raw tail is kept for the final end reflect."""
        samples = np.asarray(samples, np.float32)
        self._n_raw += len(samples)
        empty = torch.zeros(0, self.cfg.d_model, dtype=self.cfg.torch_dtype,
                            device=self.model.device)
        if self._padded is None:
            # Accumulate until the start reflect-pad is materializable.
            self._head = np.concatenate([self._head, samples])
            if self._n_raw > self.pad:
                head = self._head[self.pad:0:-1]
                self._padded = np.concatenate([head, self._head])
                self._raw_tail = self._head[-(self.pad + 2):]
                self._head = np.zeros((0,), np.float32)
        elif len(samples):
            self._padded = np.concatenate([self._padded, samples])
            self._raw_tail = np.concatenate(
                [self._raw_tail, samples])[-(self.pad + 2):]
        if self._padded is None:
            return empty
        if is_final and self.pad > 0:
            # End reflect-pad; total mel frames = 1 + N // hop (center).
            tail = self._raw_tail[-2:-self.pad - 2:-1]
            padded = np.concatenate([self._padded, tail])
        else:
            padded = self._padded
        pad_len = self._pad_offset + len(padded)

        outs = []
        total_mel = 1 + (pad_len - self.n_fft) // self.hop \
            if pad_len >= self.n_fft else 0
        if is_final:
            total_mel = min(total_mel, 1 + self._n_raw // self.hop)
            total_sub = max((((total_mel - 1) // 2) - 1) // 2, 0)
        while True:
            start_mel = self._mel_done
            have_full = start_mel + self.mel_per_step <= total_mel
            if not have_full and not is_final:
                break
            if is_final and not have_full:
                n_new = total_sub - start_mel // 4
                if n_new <= 0:
                    break
                n_new = min(n_new, self.s)
            else:
                n_new = self.s
            s0 = start_mel * self.hop - self._pad_offset
            buf = np.zeros((self.win_samples,), np.float32)
            seg = padded[s0:min(s0 + self.win_samples, len(padded))]
            buf[:len(seg)] = seg
            outs.append(self._step(buf, n_new)[0, :n_new])
            self._mel_done += 4 * self.s
            if is_final and n_new < self.s:
                break
            if is_final and start_mel // 4 + n_new >= total_sub:
                break
        # Drop the consumed padded prefix (everything before the next
        # step's window start).
        next_s0 = self._mel_done * self.hop
        drop = next_s0 - self._pad_offset
        if drop > 0:
            self._padded = self._padded[drop:]
            self._pad_offset = next_s0
        return torch.cat(outs, dim=0) if outs else empty


class IncrementalRecognizer:
    """Speech -> text at a constant cost a chunk: the interface of
    decode/streaming.py:StreamingRecognizer (``__call__(chunk, is_final)
    -> (token ids, done)``) over IncrementalConformerEncoder. The encoder
    frames accumulate on the device, CTC-greedy partials are computed on
    each step's new frames only, and the final label-synchronous beam
    (``beam_size > 1``) or attention greedy decode runs over all of them."""

    def __init__(self, model: ASRModel, tokenizer=None, converter=None,
                 chunk_samples: int = 8192, max_len: int = 128,
                 beam_size: int = 1, ctc_weight: float = 0.3,
                 mvn_stats=None):
        self.model = model
        self.tokenizer, self.converter = tokenizer, converter
        self.chunk_samples = chunk_samples
        self.max_len, self.beam_size = max_len, beam_size
        self.ctc_weight = ctc_weight
        self.enc = IncrementalConformerEncoder(model, mvn_stats)
        self.reset()

    def reset(self) -> None:
        self.enc.reset()
        self._hs: List[torch.Tensor] = []
        self._raw_ids: List[int] = []
        self._pending = np.zeros((0,), np.float32)

    @torch.inference_mode()
    def __call__(self, speech_chunk: np.ndarray, is_final: bool = False
                 ) -> Tuple[List[int], bool]:
        self._pending = np.concatenate(
            [self._pending, np.asarray(speech_chunk, np.float32)])
        if len(self._pending) >= self.chunk_samples or is_final:
            new = self.enc.feed(self._pending, is_final=is_final)
            self._pending = np.zeros((0,), np.float32)
            if len(new):
                self._hs.append(new)
                ids = self.model.ctc_logprobs(new[None]).argmax(-1)[0]
                self._raw_ids.extend(ids.tolist())
        if not is_final:
            return collapse_repeats(self._raw_ids,
                                    self.model.cfg.blank_id), False
        ids = []
        if self._hs:
            hs = torch.cat(self._hs, dim=0)[None]
            h_lengths = torch.full((1,), hs.shape[1], dtype=torch.long,
                                   device=hs.device)
            ids = final_decode(self.model, hs, h_lengths, self.beam_size,
                               self.max_len, self.ctc_weight)
        self.reset()
        return ids, True

    def text(self, ids: List[int]) -> str:
        return ids_text(self.tokenizer, self.converter, ids)


def final_decode(model: ASRModel, hs: torch.Tensor, h_lengths: torch.Tensor,
                 beam_size: int, max_len: int, ctc_weight: float
                 ) -> List[int]:
    """The streaming recognizers' last pass over hs [1, T', D]: the joint
    CTC / attention beam search when ``beam_size > 1``, else attention
    greedy; the token ids."""
    from .beam import BeamSearchConfig, batch_beam_search
    from .greedy import attention_greedy_decode
    if beam_size > 1:
        tokens, lengths = batch_beam_search(
            model, hs, h_lengths, BeamSearchConfig(
                beam_size=beam_size, max_len=max_len, ctc_weight=ctc_weight))
    else:
        tokens, lengths = attention_greedy_decode(model, hs, h_lengths,
                                                  max_len)
    return tokens[0, :int(lengths[0])].tolist()


def ids_text(tokenizer, converter, ids: List[int]) -> str:
    """Text of token ids, or the ids joined by spaces without a
    tokenizer and converter (as the reference's recognizers)."""
    if tokenizer is None or converter is None:
        return " ".join(map(str, ids))
    return tokenizer.tokens2text(converter.ids2tokens(ids))
