"""Default acoustic frontend: STFT -> power -> log-mel, in fp32.

Port of espnet_slurp_tpu/ops/frontend.py: FrontendConfig (every field of
the reference's) and default_frontend. The sliding-window and fused
frontends (``type``) and delta features (``delta_order``) are not ported
yet (ROADMAP.md queue 1 item 9): models/asr_model.py:unported_options
refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import stft as stft_mod
from .mel import logmel


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    # "default" (log-mel) | "sliding_window" | "fused": the port computes
    # the default.
    type: str = "default"
    fs: int = 16000
    n_fft: int = 512
    win_length: int | None = None
    hop_length: int = 128
    window: str = "hann"
    center: bool = True
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None
    htk: bool = False
    # Regression delta features: 0 = off, 1 = +delta, 2 = +delta+delta2.
    delta_order: int = 0
    delta_window: int = 2


def default_frontend(speech: torch.Tensor, speech_lengths: torch.Tensor,
                     cfg: FrontendConfig = FrontendConfig()
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N] waveform -> ([B, T, n_mels] fp32 log-mel, [B] frame lengths).
    int16 input is raw PCM, scaled by 1/32768."""
    if speech.dtype == torch.int16:
        speech = speech.float() * (1.0 / 32768.0)
    speech = speech.float()
    spec = stft_mod.stft(speech, n_fft=cfg.n_fft, win_length=cfg.win_length,
                         hop_length=cfg.hop_length, window=cfg.window,
                         center=cfg.center)
    feat_lengths = stft_mod.stft_out_lengths(
        speech_lengths, n_fft=cfg.n_fft, hop=cfg.hop_length, center=cfg.center)
    power = spec[..., 0] ** 2 + spec[..., 1] ** 2
    feats = logmel(power, feat_lengths, fs=cfg.fs, n_fft=cfg.n_fft,
                   n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
                   htk=cfg.htk)
    return feats, feat_lengths
