"""Loss factory (port of speech2text_tpu/losses/__init__.py, every key
of the JAX factory): `Loss({"model": key, "config": {...}})` with the
keys `CTC`, `Rnnt`, `Pruned_Rnnt`, `MaskedCELoss` (the CIF and SSL
tasks' cross-entropy), `MaskedKLDiv` (the NNLM task's label-smoothed KL)
and `MaeLoss` (CIF's token-count loss).

Each loss is called on a dict of tensors; the CTC loss also has
`predict(logits)`, the log-softmax its decoders read. An unknown key
raises ValueError. The two masked means divide by the global batch's
count under a process group (parallel.global_count), as JAX divides the
global batch's sum; the other losses are means over utterances, which
the ranks' average already makes global.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .ops.ctc import ctc_loss
from .ops.pruned_rnnt import rnnt_loss_pruned
from .ops.rnnt import rnnt_loss
from .parallel import global_count


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


def _position_mask(mask: torch.Tensor, T: int) -> torch.Tensor:
    """A (B, T) mask, or a (B,) vector of lengths made one, as f32."""
    if mask.ndim == 1:
        mask = torch.arange(T, device=mask.device)[None, :] < mask[:, None]
    return mask.float()


@dataclasses.dataclass
class MaskedCeLossConfig:
    label_smoothing: float = 0.0


class MaskedCeLoss:
    """Cross-entropy of (B, T, C) logits against (B, T) labels, the mean
    over the masked positions (a (B, T) mask or a (B,) vector of
    lengths); label smoothing spreads ε evenly over the C classes."""

    def __init__(self, config: MaskedCeLossConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        logits = batch["logits"].float()
        labels = batch["label"].long()
        mask = _position_mask(batch["mask"], logits.shape[1])
        lp = torch.log_softmax(logits, dim=-1)
        eps = self.config.label_smoothing
        if eps > 0.0:
            C = logits.shape[-1]
            tgt = F.one_hot(labels, C).float() * (1.0 - eps) + eps / C
            nll = -(tgt * lp).sum(dim=-1)
        else:
            nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
        return (nll * mask).sum() / global_count(mask.sum())


@dataclasses.dataclass
class MaskedKlDivConfig:
    label_smoothing: float = 0.1


class MaskedKlDivLoss:
    """KL divergence of the log-softmax from a label-smoothed one-hot
    target (1 − ε on the label, ε/(C − 1) added everywhere, its log
    clamped at 1e-10), the mean over the masked positions."""

    def __init__(self, config: MaskedKlDivConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        logits = batch["logits"].float()
        labels = batch["label"].long()
        mask = _position_mask(batch["mask"], logits.shape[1])
        C = logits.shape[-1]
        eps = self.config.label_smoothing
        tgt = F.one_hot(labels, C).float() * (1.0 - eps) + eps / (C - 1)
        lp = torch.log_softmax(logits, dim=-1)
        kl = (tgt * (torch.log(tgt.clamp(min=1e-10)) - lp)).sum(dim=-1)
        return (kl * mask).sum() / global_count(mask.sum())


@dataclasses.dataclass
class MaeLossConfig:
    normalized: bool = True


class MaeLoss:
    """The mean absolute error between predicted and true token counts,
    each divided by max(true, 1) when `normalized`."""

    def __init__(self, config: MaeLossConfig):
        self.config = config

    def __call__(self, batch: Dict[str, Any]) -> torch.Tensor:
        pred = batch["pred_token_counts"].float()
        true = batch["true_token_counts"].float()
        err = (pred - true).abs()
        if self.config.normalized:
            return (err / true.clamp(min=1.0)).mean()
        return err.mean()


_LOSSES = {"CTC": (CtcLoss, CtcLossConfig),
           "Rnnt": (RnntLoss, RnntLossConfig),
           "Pruned_Rnnt": (PrunedRnntLoss, PrunedRnntLossConfig),
           "MaskedCELoss": (MaskedCeLoss, MaskedCeLossConfig),
           "MaskedKLDiv": (MaskedKlDivLoss, MaskedKlDivConfig),
           "MaeLoss": (MaeLoss, MaeLossConfig)}


def Loss(config: Dict[str, Any]):
    """config = {"model": key, "config": {...}}; config keys the loss does
    not take are ignored, as in the JAX factory."""
    key = config["model"]
    if key not in _LOSSES:
        raise ValueError(f"unknown loss {key}; have {sorted(_LOSSES)}")
    cls, cfg_cls = _LOSSES[key]
    valid = {f.name for f in dataclasses.fields(cfg_cls)}
    kwargs = {k: v for k, v in (config.get("config") or {}).items()
              if k in valid}
    return cls(cfg_cls(**kwargs))
