"""Synthetic SLU mini corpus (SLURP-entity format) for CPU-runnable tests.

Port of espnet_slurp_tpu/slu/mini_corpus.py (numpy there, so this is the
port's own copy; the same seed writes the same corpus). Each utterance:
tones encode the spoken words; the target text follows the slurp_entity
layout 'scenario_action SEP type FILL filler SEP ... SEP transcript'
(egs2/slurp_entity/asr1/local/prepare_slurp_entity_data.py:60-64), and a
separate 'transcript' stream holds the plain words (slu1 two-pass).
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from ..data.fileio import DatadirWriter, write_wav
from ..data.mini_corpus import WORDS

INTENTS = ["audio_volume_up", "calendar_set", "play_music", "weather_query"]
ENT_TYPES = ["device", "date", "song", "place"]


def make_slu_mini_corpus(root: str | Path, n_train: int = 24, n_dev: int = 8,
                         fs: int = 16000, seed: int = 11) -> Tuple[Path, Path]:
    root = Path(root)
    rng = np.random.RandomState(seed)
    tone = {w: 220.0 * (2 ** (i / 4.0)) for i, w in enumerate(WORDS)}
    dirs = []
    for split, n in (("train", n_train), ("dev", n_dev)):
        d = root / split
        (d / "wav").mkdir(parents=True, exist_ok=True)
        with DatadirWriter(d) as writer:
            for i in range(n):
                intent = INTENTS[rng.randint(len(INTENTS))]
                n_words = rng.randint(1, 4)
                words = [WORDS[rng.randint(len(WORDS))]
                         for _ in range(n_words)]
                # entity = first word, typed by intent index (deterministic
                # mapping so the model CAN learn it)
                ents = [(ENT_TYPES[INTENTS.index(intent)], words[0])]
                segs = []
                for w in words:
                    dur = int(fs * rng.uniform(0.08, 0.15))
                    t = np.arange(dur) / fs
                    segs.append(0.3 * np.sin(2 * np.pi * tone[w] * t))
                # intent marker tone prefix
                t = np.arange(int(fs * 0.1)) / fs
                marker = 0.3 * np.sin(
                    2 * np.pi * (500 + 50 * INTENTS.index(intent)) * t)
                wav = np.concatenate([marker] + segs)
                wav = wav + 0.01 * rng.randn(len(wav))
                uid = f"{split}_{i:04d}"
                path = d / "wav" / f"{uid}.wav"
                write_wav(str(path), wav.astype(np.float32), fs)
                ent_str = " ".join(f"SEP {t} FILL {f}" for t, f in ents)
                writer["wav.scp"][uid] = str(path)
                writer["text"][uid] = \
                    f"{intent} {ent_str} SEP {' '.join(words)}"
                writer["transcript"][uid] = " ".join(words)
        dirs.append(d)
    return tuple(dirs)
