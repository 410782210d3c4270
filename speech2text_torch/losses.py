"""Loss factory (port of speech2text_tpu/losses/__init__.py, the `CTC`,
`Rnnt` and `Pruned_Rnnt` keys): `Loss({"model": key, "config": {...}})`.

Each loss is called on a dict of tensors; the CTC loss also has
`predict(logits)`, the log-softmax its decoders read. The JAX factory's other keys raise
NotImplementedError; an unknown key raises ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .ops.ctc import ctc_loss
from .ops.pruned_rnnt import rnnt_loss_pruned
from .ops.rnnt import rnnt_loss

# the keys of the JAX package's factory
KNOWN = ("CTC", "Rnnt", "Pruned_Rnnt", "MaskedCELoss", "MaskedKLDiv",
         "MaeLoss")


@dataclasses.dataclass
class CtcLossConfig:
    blank_label: int = 0
    reduction: str = "mean"


class CtcLoss:
    """The CTC loss on raw logits (f32 lattice, log_softmax inside); an
    unreachable lattice gives 0 (zero_infinity, always on, as in the JAX
    package)."""

    def __init__(self, config: CtcLossConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        return ctc_loss(batch["logits"], batch["label"],
                        batch["logits_length"], batch["label_length"],
                        blank=self.config.blank_label,
                        reduction=self.config.reduction)

    def predict(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(logits, dim=-1)


@dataclasses.dataclass
class RnntLossConfig:
    blank_label: int = 0
    reduction: str = "mean"
    clamp: float = -1.0     # clip per-utterance logits-gradients; < 0 off


class RnntLoss:
    """The full-lattice transducer loss on the joiner's (B, T, U+1, V)
    logits, in f32, with torchaudio's `clamp`."""

    def __init__(self, config: RnntLossConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        return rnnt_loss(batch["logits"], batch["label"],
                         batch["logits_length"], batch["label_length"],
                         blank=self.config.blank_label,
                         reduction=self.config.reduction,
                         clamp=self.config.clamp)


@dataclasses.dataclass
class PrunedRnntLossConfig:
    termination_symbol: int = 0
    reduction: str = "mean"


class PrunedRnntLoss:
    """The pruned transducer loss on the joiner's pruned logits, in f32."""

    def __init__(self, config: PrunedRnntLossConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        return rnnt_loss_pruned(
            batch["logits"], batch["label"], batch["ranges"],
            batch["logits_length"], batch["label_length"],
            termination_symbol=self.config.termination_symbol,
            reduction=self.config.reduction)


_PORTED = {"CTC": (CtcLoss, CtcLossConfig),
           "Rnnt": (RnntLoss, RnntLossConfig),
           "Pruned_Rnnt": (PrunedRnntLoss, PrunedRnntLossConfig)}


def Loss(config: Dict[str, Any]):
    """config = {"model": key, "config": {...}}; config keys the loss does
    not take are ignored, as in the JAX factory."""
    key = config["model"]
    if key not in KNOWN:
        raise ValueError(f"unknown loss {key}; have {sorted(KNOWN)}")
    if key not in _PORTED:
        raise NotImplementedError(f"loss {key!r} is not ported "
                                  f"({', '.join(_PORTED)})")
    cls, cfg_cls = _PORTED[key]
    valid = {f.name for f in dataclasses.fields(cfg_cls)}
    kwargs = {k: v for k, v in (config.get("config") or {}).items()
              if k in valid}
    return cls(cfg_cls(**kwargs))
