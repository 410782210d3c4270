"""The pruned transducer loss of the port's loss factory (port of
speech2text_tpu/losses/__init__.py, key `Pruned_Rnnt`): the mean over
utterances of the pruned lattice's loss, in f32."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .ops.pruned_rnnt import rnnt_loss_pruned


class PrunedRnntLoss:
    """Built from the YAML's `loss.config` (termination_symbol,
    reduction; other keys are ignored, as in the JAX factory)."""

    def __init__(self, config: Dict[str, Any]):
        self.termination_symbol = int(config.get("termination_symbol", 0))
        self.reduction = str(config.get("reduction", "mean"))

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        return rnnt_loss_pruned(
            batch["logits"], batch["label"], batch["ranges"],
            batch["logits_length"], batch["label_length"],
            termination_symbol=self.termination_symbol,
            reduction=self.reduction)
