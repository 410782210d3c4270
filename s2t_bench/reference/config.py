"""`from_dict` of the port's config module (speech2text_torch/config.py):
a dataclass from a config dict, refusing unknown keys."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def from_dict(cls: Type[T], cfg: Dict[str, Any] | None) -> T:
    """Build a dataclass from a config dict, erroring on unknown keys."""
    cfg = dict(cfg or {})
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - names
    if unknown:
        raise ValueError(
            f"{cls.__name__}: unknown config keys {sorted(unknown)}; "
            f"valid keys: {sorted(names)}")
    return cls(**cfg)
