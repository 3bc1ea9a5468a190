"""Native host IO: C++ WAV decoder, threaded batch loader and edit-distance
scorer (ctypes). This package's own copy of espnet_slurp_tpu/native/.

Each shared library is built from its source here with g++ at first use,
into ``build/native/<source stem>-<hash of the source and flags>.so`` beside
the package (a listed-as-ignored build directory; nothing is built into the
package tree), so an edited source rebuilds. As in the reference, every
entry point returns None when the toolchain or the library is unavailable
and the callers fall back to Python (scipy/wave decoding, the Python
Levenshtein DP): this is host file decoding and scoring, not device work.
``ESPNET_NO_NATIVE_IO`` set in the environment turns the native path off.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("espnet_slurp_tpu_torch")

_HERE = Path(__file__).resolve().parent
BUILD_ROOT = _HERE.parents[1] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LIBS = {}


def _build(src: Path) -> Optional[Path]:
    """The library built from ``src`` (built now if this source has none
    yet), or None when g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + src.read_bytes())
    so = BUILD_ROOT / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    tmp = None
    try:
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_ROOT, suffix=".so")
        os.close(fd)
        subprocess.run(["g++", *_FLAGS, str(src), "-o", tmp, "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
        return so
    except Exception as e:  # no g++ / unwritable build dir
        log.info("native build of %s unavailable (%s); python fallback",
                 src.name, e)
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _library(stem: str, declare) -> Optional[ctypes.CDLL]:
    """The loaded library of ``<stem>.cpp`` with its signatures set by
    ``declare``, or None (cached either way)."""
    if stem in _LIBS:
        return _LIBS[stem]
    lib = None
    if not os.environ.get("ESPNET_NO_NATIVE_IO"):
        so = _build(_HERE / f"{stem}.cpp")
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
                declare(lib)
            except OSError as e:
                log.info("native %s load failed (%s)", stem, e)
                lib = None
    _LIBS[stem] = lib
    return lib


def _declare_wavio(lib):
    lib.wavio_read.restype = ctypes.c_long
    lib.wavio_read.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                               ctypes.POINTER(ctypes.c_int)]
    lib.wavio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.wavio_num_samples.restype = ctypes.c_long
    lib.wavio_num_samples.argtypes = [ctypes.c_char_p]
    lib.wavio_read_batch.restype = ctypes.c_int
    lib.wavio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]


def _declare_edit_distance(lib):
    lib.edit_stats_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]


def _load():
    return _library("wavio", _declare_wavio)


def _load_ed():
    return _library("edit_distance", _declare_edit_distance)


def available() -> bool:
    return _load() is not None


def load_wav(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode one file natively; None => caller should fall back."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int(0)
    n = lib.wavio_read(str(path).encode(), ctypes.byref(out),
                       ctypes.byref(sr))
    if n < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.wavio_free(out)
    return arr, int(sr.value)


def num_samples(path: str) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    n = lib.wavio_num_samples(str(path).encode())
    return int(n) if n >= 0 else None


def load_batch(paths: Sequence[str], pad_to: int,
               n_threads: int = 8) -> Optional[Tuple[np.ndarray,
                                                     np.ndarray]]:
    """Decode a batch on the C++ thread pool into one padded buffer.

    Returns (wavs [B, pad_to] float32 zero-padded, lengths [B] int32), or
    None if any file needs the Python fallback.
    """
    lib = _load()
    if lib is None or not paths:
        return None
    b = len(paths)
    buf = np.zeros((b, pad_to), np.float32)
    lengths = np.zeros((b,), np.int32)
    arr = (ctypes.c_char_p * b)(*[str(p).encode() for p in paths])
    rc = lib.wavio_read_batch(
        arr, b, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad_to, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    if rc != 0:
        return None
    return buf, lengths


def edit_stats_batch(refs: Sequence[Sequence[int]],
                     hyps: Sequence[Sequence[int]],
                     n_threads: int = 8) -> Optional[np.ndarray]:
    """Batch Levenshtein alignment counts on the C++ thread pool.

    refs/hyps: per-utterance integer token id sequences. Returns
    [B, 4] int32 (hits, subs, dels, ins) with tie-breaking identical to
    utils/metrics.align_stats, or None when the native path is unavailable.
    """
    lib = _load_ed()
    if lib is None:
        return None
    b = len(refs)
    flat_r = np.asarray([t for r in refs for t in r], np.int32)
    flat_h = np.asarray([t for h in hyps for t in h], np.int32)
    off_r = np.zeros((b + 1,), np.int64)
    off_h = np.zeros((b + 1,), np.int64)
    np.cumsum([len(r) for r in refs], out=off_r[1:])
    np.cumsum([len(h) for h in hyps], out=off_h[1:])
    out = np.zeros((b, 4), np.int32)
    # keep arrays non-empty for ctypes pointers
    if flat_r.size == 0:
        flat_r = np.zeros((1,), np.int32)
    if flat_h.size == 0:
        flat_h = np.zeros((1,), np.int32)
    lib.edit_stats_batch(
        flat_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        off_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flat_h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        off_h.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    return out
