"""Component registries: this package's own copy of
espnet_slurp_tpu/utils/registry.py (the ClassChoices plugin mechanism).

Parity target: reference espnet2/train/class_choices.py (string -> class
indirection behind every ``--encoder conformer --encoder_conf ...`` flag).
User code registers its own components:

    from espnet_slurp_tpu_torch.utils.registry import encoders

    @encoders.register("my_encoder")
    class MyEncoder(nn.Module): ...

and selects them through the config (``model: {encoder: my_encoder}``).
A registered encoder is built as ``cls(cfg, idim)``, with the model's
ASRConfig and the width of the features it is given, and its forward
returns ``(hs, h_lengths, taps)`` as models/conformer.py:ConformerEncoder's.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, type] = {}

    def register(self, key: str) -> Callable[[T], T]:
        def deco(cls: T) -> T:
            if key in self._map:
                raise ValueError(f"{self.name}:{key} already registered")
            self._map[key] = cls
            return cls
        return deco

    def add(self, key: str, cls) -> None:
        self.register(key)(cls)

    def get(self, key: str):
        if key not in self._map:
            raise KeyError(
                f"unknown {self.name} {key!r}; choices: {self.choices()}")
        return self._map[key]

    def choices(self) -> Iterable[str]:
        return sorted(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map


encoders = Registry("encoder")
decoders = Registry("decoder")
