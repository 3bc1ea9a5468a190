"""Kaldi-style data-dir file I/O: this package's own copy of
espnet_slurp_tpu/data/fileio.py.

Parity target: reference espnet2/fileio/ (read_2column_text, SoundScpReader,
NpyScpReader, DatadirWriter — SURVEY.md §2.2). Audio goes through
scipy.io.wavfile / stdlib wave (soundfile is not available in this image);
features can also be .npy files.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np


def read_2column_text(path: str | Path) -> Dict[str, str]:
    """'uttid value...' per line -> {uttid: value} (text.py:read_2column_text)."""
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) == 2 else ""
    return out


def load_wav(path: str, keep_channels: bool = False
             ) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 waveform in [-1, 1], sample rate).

    Fast path: the native C++ decoder (native/wavio.cpp); scipy decodes
    anything the native parser declines (exotic codecs/containers).
    keep_channels=True returns [T, C] for multichannel files (reference
    sound loader keeps channels; enh beamformer/FaSNet consume them) —
    that path always decodes via scipy since the native decoder extracts
    channel 0."""
    if not keep_channels:
        from .. import native
        got = native.load_wav(path)
        if got is not None:
            return got
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2 and not keep_channels:
        data = data[:, 0]  # multi-channel: keep channel 0 (ref selects ch)
    return data, sr


def wav_num_samples(path: str) -> int:
    """Sample count from the RIFF header only (native parser, then stdlib
    wave; scipy decodes as last resort for non-PCM containers)."""
    from .. import native
    n = native.num_samples(path)
    if n is not None:
        return n
    import wave
    try:
        with wave.open(path, "rb") as f:
            return int(f.getnframes())
    except Exception:
        return int(load_wav(path)[0].shape[0])


def write_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    from scipy.io import wavfile
    wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, wav16)


class SoundScpReader(Mapping):
    """wav.scp reader: {uttid: path} -> waveform arrays on demand."""

    def __init__(self, path: str, dtype=np.float32,
                 keep_channels: bool = False):
        self._map = read_2column_text(path)
        self.dtype = dtype
        self.keep_channels = keep_channels

    def __getitem__(self, key) -> np.ndarray:
        wav, _sr = load_wav(self._map[key], self.keep_channels)
        return wav.astype(self.dtype)

    def shape(self, key) -> int:
        """Sample count from the file HEADER — no decode. Startup shape
        collection over a big corpus must not read audio data; the
        reference uses precomputed shape files (abs_task.py:1477-1553)."""
        return wav_num_samples(self._map[key])

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


class NpyScpReader(Mapping):
    """feats.scp of .npy paths (espnet2/fileio/npy_scp.py)."""

    def shape(self, key):
        arr = np.load(self._map[key], mmap_mode="r")
        return int(arr.shape[0])

    def __init__(self, path: str):
        self._map = read_2column_text(path)

    def __getitem__(self, key) -> np.ndarray:
        return np.load(self._map[key])

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


class DatadirWriter:
    """Nested writer for Kaldi-style output dirs (espnet2/fileio/datadir_writer.py).

    writer["text"][uttid] = "..." buffers lines; close() flushes sorted files.
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._files: Dict[str, Dict[str, str]] = {}

    def __getitem__(self, name: str) -> "_FileProxy":
        if name not in self._files:
            self._files[name] = {}
        return _FileProxy(self._files[name])

    def close(self):
        for name, rows in self._files.items():
            p = self.root / name
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "w", encoding="utf-8") as f:
                for k in sorted(rows):
                    f.write(f"{k} {rows[k]}\n")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _FileProxy:
    def __init__(self, store: Dict[str, str]):
        self._store = store

    def __setitem__(self, key: str, value: str):
        self._store[key] = value
