"""YAML config system with dataclass round-trip: this package's own copy of
espnet_slurp_tpu/utils/config.py.

Parity target: the reference's layered config machinery (SURVEY.md §5:
argparse + --config YAML merge + NestedDictAction + --print_config dumping
the fully-resolved YAML, saved to exp/config.yaml and reloaded verbatim for
inference — abs_task.py:887-999,1164-1174,1792-1835). Here the resolved
config is a nested dataclass tree; to_dict/from_dict give the YAML
round-trip, and the exp-dir copy is the single source of truth at inference.
"""
from __future__ import annotations

import dataclasses
import typing
from pathlib import Path
from typing import Any, Dict, Type, TypeVar

import yaml

T = TypeVar("T")


# Field metadata of an option the reference's config has no key for (e.g.
# ASRConfig.fused_conv, which the reference reads from the environment).
PORT_ONLY = {"port_only": True}


def _written(obj, f) -> bool:
    """A port-only field is written only when it is set away from its
    default, so that the reference's loader reads a config that keeps it."""
    if not f.metadata.get("port_only"):
        return True
    return getattr(obj, f.name) != f.default


def to_dict(obj: Any) -> Any:
    """Dataclass tree -> plain dict/list/scalars (YAML-serializable)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if _written(obj, f)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, type):  # e.g. a dtype class stored in a config
        return obj.__name__
    if hasattr(obj, "dtype") and hasattr(obj, "name"):  # dtype-like
        return str(obj.name)
    return obj


def _resolve_type(tp, value):
    origin = typing.get_origin(tp)
    if value is None:
        return None
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if origin in (list, tuple) or tp in (list, tuple):
        args = typing.get_args(tp)
        elem = args[0] if args else None
        out = [_resolve_type(elem, v) if elem else v for v in value]
        return tuple(out) if (origin is tuple or tp is tuple) else out
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return _resolve_type(args[0], value)
        return value
    if tp in (int, float, str, bool):
        return tp(value)
    return value


def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    """Plain dict -> dataclass tree, recursing into nested dataclass fields.

    Unknown keys raise (catches config typos, like typeguard did for the
    reference). Fields absent from the dict keep their defaults.
    """
    if d is None:
        d = {}
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {unknown}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for k, v in d.items():
        kwargs[k] = _resolve_type(hints.get(k, Any), v)
    return cls(**kwargs)


def load_yaml(path: str | Path) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(obj: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(obj), f, sort_keys=False)


def merge_dicts(base: Dict, override: Dict) -> Dict:
    """Deep-merge override into base (config file + CLI overrides)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out
