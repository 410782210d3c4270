"""Loss factory (port of speech2text_tpu/losses/__init__.py, the
`Pruned_Rnnt` key): `Loss({"model": key, "config": {...}})`.

Only the pruned RNN-T loss is ported; every other key of the JAX factory
raises NotImplementedError, and an unknown key raises ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .ops.pruned_rnnt import rnnt_loss_pruned

# the keys of the JAX package's factory
KNOWN = ("CTC", "Rnnt", "Pruned_Rnnt", "MaskedCELoss", "MaskedKLDiv",
         "MaeLoss")


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


def Loss(config: Dict[str, Any]) -> PrunedRnntLoss:
    """config = {"model": key, "config": {...}}; config keys the loss does
    not take are ignored, as in the JAX factory."""
    key = config["model"]
    if key not in KNOWN:
        raise ValueError(f"unknown loss {key}; have {sorted(KNOWN)}")
    if key != "Pruned_Rnnt":
        raise NotImplementedError(f"loss {key!r} is not ported "
                                  f"(Pruned_Rnnt only)")
    valid = {f.name for f in dataclasses.fields(PrunedRnntLossConfig)}
    kwargs = {k: v for k, v in (config.get("config") or {}).items()
              if k in valid}
    return PrunedRnntLoss(PrunedRnntLossConfig(**kwargs))
