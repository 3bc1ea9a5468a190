"""Dataset over named streams + preprocessing: this package's own copy of
espnet_slurp_tpu/data/dataset.py.

Parity target: reference espnet2/train/dataset.py (ESPnetDataset: N named
(path, name, type) loaders -> per-utt dict) and espnet2/train/preprocessor.py
(CommonPreprocessor: tokenize text -> int ids). Supported loader types cover
the ones the recipes actually use: sound (wav.scp), npy, text, text_int.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .fileio import NpyScpReader, SoundScpReader, read_2column_text
from .tokenizer import AbsTokenizer, TokenIDConverter

DATA_TYPES = {}


def _register(name):
    def deco(fn):
        DATA_TYPES[name] = fn
        return fn
    return deco


@_register("sound")
def _load_sound(path):
    return SoundScpReader(path)


@_register("sound_mc")
def _load_sound_mc(path):
    """Multichannel wav.scp: arrays come back [T, C] (enh beamformer /
    FaSNet mixtures; reference sound loader keeps channels)."""
    return SoundScpReader(path, keep_channels=True)


@_register("npy")
def _load_npy(path):
    return NpyScpReader(path)


class _KaldiArkLoader(Mapping):
    """feats.scp of 'ark_path:offset' entries, binary float/double matrices
    (reference uses kaldiio for espnet2/train/dataset.py 'kaldi_ark'; this
    is a minimal in-framework reader for the \0B BFM/BDM format)."""

    def __init__(self, path):
        self._map = read_2column_text(path)

    @staticmethod
    def _read_matrix(f):
        binmark = f.read(2)
        if binmark != b"\x00B":
            raise ValueError("only binary kaldi archives are supported")
        kind = f.read(3)
        if kind not in (b"FM ", b"DM "):
            raise ValueError(f"unsupported kaldi matrix type {kind!r}")
        dtype = np.float32 if kind == b"FM " else np.float64

        def read_int():
            size = f.read(1)[0]
            return int.from_bytes(f.read(size), "little")

        rows = read_int()
        cols = read_int()
        buf = f.read(rows * cols * np.dtype(dtype).itemsize)
        return np.frombuffer(buf, dtype=dtype).reshape(rows, cols)

    def __getitem__(self, key) -> np.ndarray:
        entry = self._map[key]
        ark, _, offset = entry.rpartition(":")
        with open(ark, "rb") as f:
            f.seek(int(offset))
            return np.ascontiguousarray(self._read_matrix(f))

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


DATA_TYPES["kaldi_ark"] = _KaldiArkLoader


class _Hdf5Loader(Mapping):
    """'file.h5:dataset_key' entries (espnet2 'hdf5' loader)."""

    def __init__(self, path):
        self._map = read_2column_text(path)
        self._files = {}

    def _file(self, fname):
        if fname not in self._files:
            import h5py
            self._files[fname] = h5py.File(fname, "r")
        return self._files[fname]

    def __getitem__(self, key) -> np.ndarray:
        entry = self._map[key]
        fname, _, dkey = entry.rpartition(":")
        return np.asarray(self._file(fname)[dkey])

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


DATA_TYPES["hdf5"] = _Hdf5Loader


class _TextNumLoader(Mapping):
    """text_int / text_float / csv_int / csv_float loaders
    (train/dataset.py:249-288): whitespace- or comma-separated numbers."""

    def __init__(self, path, dtype=np.int64, sep=None):
        self._map = read_2column_text(path)
        self._dtype = dtype
        self._sep = sep

    def __getitem__(self, k):
        return np.array([float(x) for x in self._map[k].split(self._sep)],
                        dtype=self._dtype)

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


DATA_TYPES["text_int"] = _TextNumLoader
DATA_TYPES["text_float"] = lambda p: _TextNumLoader(p, np.float32)
DATA_TYPES["csv_int"] = lambda p: _TextNumLoader(p, np.int64, ",")
DATA_TYPES["csv_float"] = lambda p: _TextNumLoader(p, np.float32, ",")
# duration: frame counts per token (train/dataset.py:221; FastSpeech GT
# durations) — same numeric layout as text_int.
DATA_TYPES["duration"] = _TextNumLoader


class _TextLoader(Mapping):
    def __init__(self, path):
        self._map = read_2column_text(path)

    def __getitem__(self, k):
        return self._map[k]

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(self._map)


DATA_TYPES["text"] = _TextLoader


class _RandGenLoader(Mapping):
    """Random-array loader over a shape file (fileio/rand_gen_dataset.py:
    'rand_float' / 'rand_int_<low>_<high>' DATA_TYPES): path maps
    uid -> 'd1,d2,...'; arrays are generated deterministically per uid."""

    def __init__(self, shape_path: str, low=None, high=None):
        self._shapes = {u: tuple(int(d) for d in s.split(","))
                        for u, s in read_2column_text(shape_path).items()}
        self._low, self._high = low, high

    def __getitem__(self, key):
        rng = np.random.RandomState(hash(key) % (2 ** 31))
        shape = self._shapes[key]
        if self._low is None:
            return rng.randn(*shape).astype(np.float32)
        return rng.randint(self._low, self._high + 1,
                           size=shape).astype(np.int64)

    def shape(self, key):
        return self._shapes[key][0]

    def __len__(self):
        return len(self._shapes)

    def __iter__(self):
        return iter(self._shapes)


def build_loader(path: str, typ: str) -> Mapping:
    """DATA_TYPES dispatch incl. parametric 'rand_int_<low>_<high>'
    (train/dataset.py:192-340)."""
    if typ == "rand_float":
        return _RandGenLoader(path)
    if typ.startswith("rand_int_"):
        low, high = map(int, typ[len("rand_int_"):].split("_"))
        return _RandGenLoader(path, low, high)
    if typ not in DATA_TYPES:
        raise ValueError(f"unknown data type {typ}")
    return DATA_TYPES[typ](path)


def detect_non_silence(x: np.ndarray, threshold: float = 0.01,
                       frame_length: int = 1024,
                       frame_shift: int = 512) -> np.ndarray:
    """Power-based VAD mask over samples (preprocessor.py:71-118): frames
    whose power exceeds ``threshold`` x the utterance mean power count as
    speech. Used so RIR/noise power normalization measures SPEECH power,
    not silence-diluted power."""
    if x.shape[-1] < frame_length:
        return np.ones(x.shape, bool)
    n = 1 + (x.shape[-1] - frame_length) // frame_shift
    idx = np.arange(n)[:, None] * frame_shift + np.arange(frame_length)
    power = (x[idx] ** 2).mean(axis=-1)
    mean_power = power.mean()
    if mean_power == 0:
        return np.ones(x.shape, bool)
    detect = np.repeat(power / mean_power > threshold, frame_shift)
    return np.pad(detect, (0, x.shape[-1] - len(detect)),
                  constant_values=detect[-1] if len(detect) else True)


class CommonPreprocessor:
    """Tokenize named text streams to int id arrays (preprocessor.py:123-332).

    ``text_names`` lists which streams are text needing tokenization; each may
    have its own tokenizer/converter (the SLU task adds a word-level
    'transcript' stream — SLUPreprocessor, preprocessor.py:335-414).
    """

    def __init__(self,
                 tokenizer: Optional[AbsTokenizer] = None,
                 converter: Optional[TokenIDConverter] = None,
                 text_names: Sequence[str] = ("text",),
                 extra: Optional[Dict[str, Tuple[AbsTokenizer,
                                                 TokenIDConverter]]] = None,
                 rir_scp: Optional[str] = None,
                 rir_apply_prob: float = 1.0,
                 noise_scp: Optional[str] = None,
                 noise_apply_prob: float = 1.0,
                 noise_db_range: Tuple[float, float] = (13.0, 30.0),
                 speech_name: str = "speech",
                 speech_volume_normalize: Optional[float] = None,
                 cleaner: Optional[Callable[[str], str]] = None,
                 seed: int = 0):
        self.tokenizer = tokenizer
        self.converter = converter
        self.text_names = tuple(text_names)
        self.extra = extra or {}
        # text cleaner applied before tokenization (espnet2/text/cleaner.py
        # TextCleaner, wired via preprocessor text_cleaner)
        self.cleaner = cleaner
        # RIR convolution + noise mixing (preprocessor.py:123-332): applied
        # host-side per utterance before collation, like the reference.
        self.speech_name = speech_name
        self.rir_apply_prob = rir_apply_prob
        self.noise_apply_prob = noise_apply_prob
        self.noise_db_range = noise_db_range
        # peak normalization (preprocessor.py:306-309)
        self.speech_volume_normalize = speech_volume_normalize
        self._rng = np.random.RandomState(seed)
        self._rirs = list(read_2column_text(rir_scp).values()) \
            if rir_scp else []
        self._noises = list(read_2column_text(noise_scp).values()) \
            if noise_scp else []

    def _augment_speech(self, x: np.ndarray) -> np.ndarray:
        from .fileio import load_wav
        rng = self._rng
        # VAD-gated power (preprocessor.py:226): silence-diluted power
        # would over-scale quiet utterances' noise/RIR normalization.
        vad = detect_non_silence(x)
        power = float(np.mean(x[vad] ** 2)) + 1e-12
        if self._rirs and rng.rand() < self.rir_apply_prob:
            rir, _ = load_wav(self._rirs[rng.randint(len(self._rirs))])
            x = np.convolve(x, rir, mode="full")[: len(x)]
            # renormalize to the dry speech power (preprocessor.py:197-227)
            p2 = float(np.mean(x[detect_non_silence(x)] ** 2)) + 1e-12
            x = x * np.sqrt(power / p2)
        if self._noises and rng.rand() < self.noise_apply_prob:
            noise, _ = load_wav(self._noises[rng.randint(len(self._noises))])
            if len(noise) < len(x):
                noise = np.tile(noise, -(-len(x) // len(noise)))
            off = rng.randint(len(noise) - len(x) + 1)
            noise = noise[off:off + len(x)]
            snr = rng.uniform(*self.noise_db_range)
            n_power = float(np.mean(noise ** 2)) + 1e-12
            scale = np.sqrt(power / (10 ** (snr / 10) * n_power))
            x = x + scale * noise
        if self.speech_volume_normalize is not None:
            ma = float(np.abs(x).max()) + 1e-12
            x = x * (self.speech_volume_normalize / ma)
        return x.astype(np.float32)

    def __call__(self, uid: str, data: Dict[str, object]) -> Dict[str, np.ndarray]:
        out = {}
        for name, value in data.items():
            if name == self.speech_name and not isinstance(value, str) \
                    and (self._rirs or self._noises
                         or self.speech_volume_normalize is not None):
                out[name] = self._augment_speech(np.asarray(value))
                continue
            if isinstance(value, str):
                if name in self.extra:
                    tok, conv = self.extra[name]
                elif name in self.text_names and self.tokenizer is not None:
                    tok, conv = self.tokenizer, self.converter
                else:
                    continue  # raw text stream left out of the batch
                if self.cleaner is not None:
                    value = self.cleaner(value)
                ids = conv.tokens2ids(tok.text2tokens(value))
                out[name] = np.asarray(ids, dtype=np.int64)
            else:
                out[name] = value
        return out


class SpeechDataset:
    """Map-style dataset over named loaders (dataset.py:357-540 analogue)."""

    def __init__(self,
                 path_name_type_list: Sequence[Tuple[str, str, str]],
                 preprocess: Optional[Callable] = None):
        self.loaders: Dict[str, Mapping] = {}
        for path, name, typ in path_name_type_list:
            self.loaders[name] = build_loader(path, typ)
        self.preprocess = preprocess
        first = next(iter(self.loaders.values()))
        self.keys: List[str] = sorted(first)
        for name, loader in self.loaders.items():
            missing = set(self.keys) - set(loader)
            if missing:
                raise RuntimeError(
                    f"stream {name} missing utts: {sorted(missing)[:5]}")

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, uid: str | int):
        if isinstance(uid, int):
            uid = self.keys[uid]
        data = {name: loader[uid] for name, loader in self.loaders.items()}
        if self.preprocess is not None:
            data = self.preprocess(uid, data)
        return uid, data

    def item_without(self, uid: str | int, skip: tuple = ("speech",)):
        """Load all streams EXCEPT ``skip`` (the device-resident speech
        path, data/resident.py: the waveform never touches the host
        pipeline)."""
        if isinstance(uid, int):
            uid = self.keys[uid]
        data = {name: loader[uid] for name, loader in self.loaders.items()
                if name not in skip}
        if self.preprocess is not None:
            data = self.preprocess(uid, data)
        return uid, data


class IterableSpeechDataset:
    """Order-following streaming dataset (espnet2/train/iterable_dataset.py
    IterableESPnetDataset analogue): iterates manifests line-by-line in file
    order without building an index, for inference / collect-stats over
    corpora too large to enumerate up front."""

    def __init__(self,
                 path_name_type_list: Sequence[Tuple[str, str, str]],
                 preprocess: Optional[Callable] = None):
        self.specs = list(path_name_type_list)
        self.preprocess = preprocess

    def __iter__(self):
        files = [open(path, encoding="utf-8") for path, _, _ in self.specs]
        loaders = [build_loader(path, typ)
                   for path, _, typ in self.specs]
        try:
            for lines in zip(*files):
                uid = None
                data = {}
                for (path, name, typ), line, loader in zip(
                        self.specs, lines, loaders):
                    key = line.split(maxsplit=1)[0]
                    if uid is None:
                        uid = key
                    elif key != uid:
                        raise RuntimeError(
                            f"stream order mismatch: {key} != {uid}")
                    data[name] = loader[key]
                if self.preprocess is not None:
                    data = self.preprocess(uid, data)
                yield uid, data
        finally:
            for f in files:
                f.close()
