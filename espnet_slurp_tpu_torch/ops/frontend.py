"""Acoustic frontends, in fp32: log-mel (default), sliding-window raw
frames and their concatenation, with optional delta features.

Port of espnet_slurp_tpu/ops/frontend.py: FrontendConfig (every field of
the reference's), default_frontend (which dispatches on ``type`` as the
reference's does), delta_features / add_deltas (regression deltas with
per-utterance edge replication), sliding_window_frontend and
fused_frontend. ``feature_dim`` is the width of the features a config
gives, which the encoder's input layer takes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import stft as stft_mod
from .mel import logmel


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    # "default" (log-mel) | "sliding_window" (raw frames) | "fused"
    # (log-mel ++ sliding-window frames, frame-aligned by the shared hop).
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
    if cfg.type == "sliding_window":
        return sliding_window_frontend(speech, speech_lengths, cfg)
    if cfg.type == "fused":
        return fused_frontend(speech, speech_lengths, cfg)
    spec = stft_mod.stft(speech, n_fft=cfg.n_fft, win_length=cfg.win_length,
                         hop_length=cfg.hop_length, window=cfg.window,
                         center=cfg.center)
    feat_lengths = stft_mod.stft_out_lengths(
        speech_lengths, n_fft=cfg.n_fft, hop=cfg.hop_length, center=cfg.center)
    power = spec[..., 0] ** 2 + spec[..., 1] ** 2
    feats = logmel(power, feat_lengths, fs=cfg.fs, n_fft=cfg.n_fft,
                   n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax,
                   htk=cfg.htk)
    if cfg.delta_order > 0:
        feats = add_deltas(feats, order=cfg.delta_order,
                           window=cfg.delta_window, ilens=feat_lengths)
    return feats, feat_lengths


def delta_features(feats: torch.Tensor, window: int = 2,
                   ilens: torch.Tensor | None = None) -> torch.Tensor:
    """Regression deltas (the Kaldi formula): d_t = sum_n n (f_{t+n} -
    f_{t-n}) / (2 sum n^2), each utterance edge-replicated at its own last
    valid frame (not at the padded batch edge). [B, T, F] -> [B, T, F]."""
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    b, t, f = feats.shape
    ar = torch.arange(t, device=feats.device)[None, :]
    if ilens is None:
        last = torch.full((b, 1), t - 1, device=feats.device)
    else:
        last = (ilens.to(feats.device).clamp_min(1) - 1)[:, None]
    out = torch.zeros_like(feats)
    for n in range(1, window + 1):
        idx_p = torch.minimum(ar + n, last)
        idx_m = torch.minimum((ar - n).clamp_min(0), last)
        take = lambda idx: feats.gather(
            1, idx.long()[..., None].expand(b, t, f))
        out = out + n * (take(idx_p) - take(idx_m))
    return out / denom


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2,
               ilens: torch.Tensor | None = None) -> torch.Tensor:
    """[B, T, F] -> [B, T, F (1 + order)]: base, delta, delta-delta..."""
    outs = [feats]
    for _ in range(order):
        outs.append(delta_features(outs[-1], window, ilens=ilens))
    return torch.cat(outs, dim=-1)


def sliding_window_frontend(speech: torch.Tensor,
                            speech_lengths: torch.Tensor,
                            cfg: FrontendConfig = FrontendConfig()
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N] waveform -> ([B, T, win_length] raw frames, [B] frame
    lengths): the STFT's framing (zero centre padding of n_fft // 2,
    n_fft-wide frames, the centred win_length slice), so that T and the
    lengths are the log-mel path's."""
    speech = speech.float()
    win = cfg.win_length or cfg.n_fft
    if cfg.center:
        pad = cfg.n_fft // 2
        speech = torch.nn.functional.pad(speech, (pad, pad))
    frames = stft_mod.frame_signal(speech, cfg.n_fft, cfg.hop_length)
    off = (cfg.n_fft - win) // 2
    feat_lengths = stft_mod.stft_out_lengths(
        speech_lengths, n_fft=cfg.n_fft, hop=cfg.hop_length, center=cfg.center)
    return frames[..., off:off + win], feat_lengths


def fused_frontend(speech: torch.Tensor, speech_lengths: torch.Tensor,
                   cfg: FrontendConfig = FrontendConfig()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-mel (with ``cfg``'s deltas) ++ sliding-window frames on the
    feature axis; both share the hop and the framing, so their frames
    align."""
    mels, feat_lengths = default_frontend(
        speech, speech_lengths, dataclasses.replace(cfg, type="default"))
    raw, _ = sliding_window_frontend(speech, speech_lengths, cfg)
    t = min(mels.shape[1], raw.shape[1])
    return torch.cat([mels[:, :t], raw[:, :t]], dim=-1), feat_lengths


def feature_dim(cfg: FrontendConfig) -> int:
    """The width of the features ``cfg`` gives: n_mels (1 + delta_order)
    for log-mel, win_length (else n_fft) for raw frames, their sum for
    ``fused``."""
    mel = cfg.n_mels * (1 + cfg.delta_order)
    raw = cfg.win_length or cfg.n_fft
    return {"sliding_window": raw, "fused": mel + raw}.get(cfg.type, mel)
