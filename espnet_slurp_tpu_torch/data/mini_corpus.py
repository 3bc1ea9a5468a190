"""Synthetic mini corpus generator — the mini_an4 analogue (SURVEY.md §4):
this package's own copy of espnet_slurp_tpu/data/mini_corpus.py.

Generates a tiny deterministic speech corpus where each label token maps to a
fixed tone; utterances are concatenated tones + noise. Used by the CPU-runnable
end-to-end smoke recipe and tests (the reference uses the 4-utterance an4
corpus for the same purpose, egs2/mini_an4/).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .fileio import DatadirWriter, write_wav

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet"]


def make_mini_corpus(root: str | Path, n_train: int = 32, n_dev: int = 8,
                     fs: int = 16000, seed: int = 7) -> Tuple[Path, Path]:
    """Write {root}/{train,dev}/{wav.scp,text} + wavs. Returns dir paths."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    tone_freqs = {w: 220.0 * (2 ** (i / 4.0)) for i, w in enumerate(WORDS)}
    dirs = []
    for split, n in (("train", n_train), ("dev", n_dev)):
        d = root / split
        wav_dir = d / "wav"
        wav_dir.mkdir(parents=True, exist_ok=True)
        with DatadirWriter(d) as writer:
            for i in range(n):
                n_words = rng.randint(1, 4)
                words = [WORDS[rng.randint(len(WORDS))] for _ in range(n_words)]
                segs = []
                for w in words:
                    dur = int(fs * rng.uniform(0.08, 0.15))
                    t = np.arange(dur) / fs
                    segs.append(0.3 * np.sin(2 * np.pi * tone_freqs[w] * t))
                wav = np.concatenate(segs) + 0.01 * rng.randn(
                    sum(len(s) for s in segs))
                uid = f"{split}_{i:04d}"
                path = wav_dir / f"{uid}.wav"
                write_wav(str(path), wav.astype(np.float32), fs)
                writer["wav.scp"][uid] = str(path)
                writer["text"][uid] = " ".join(words)
        dirs.append(d)
    return tuple(dirs)
