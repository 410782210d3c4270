"""The reference training step of BEST-RQ pretraining (Chiu et al. 2022,
arXiv:2202.01855) with a relative-position Conformer, in plain PyTorch:
the port's Trainer.train_step for its SSL task (speech2text_torch/
tasks/ssl.py) on one process, with no kernels.

A step featurizes the PCM batch twice (`step.Featurizer`: the raw view,
then the augmented one, augmentation drawn from the step's augmentation
generator), takes the labels from the raw view (models/rq.py), draws
the span starts and the noise from the same generator and masks the
augmented view, runs the Conformer (models/conformer_rel.py; dropout
from the step's dropout generator) and the logits layer, a Dense of
the encoder's width to num_codebooks · codebook_size in f32, and takes
the cross-entropy of every codebook's logits on the masked valid frames
(`loss_selection: mask_loss`; on every valid frame with "all"), the
mean over codebooks and frames; then the backward, the global-norm
clip and AdamW under Warmup (optim/adamw.py).

Every product runs in the dtype the config gives its layer (the
Conformer's Dense and Conv layers in `encoder.config.dtype`, the logits
layer in f32), so that check.lower_precision reaches each of them; the
parameters, norms, scores, softmax and the loss are f32; TF32 is off.

`check_config(config)` raises ValueError where ReferenceTrainer would
(task, encoder, masking, loss, optimizer), by reading the config and
building the model on the meta device; `check_traffic(config, traffic)`
raises where the mix's audio is not what the frontend reads (its sample
rate) or it lacks the noise clips that augmentation mixes in. The mix's
labels are not read: pretraining has none.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from .config import from_dict
from .models.conformer_rel import ConformerRel, ConformerRelConfig
from .models.layers import Dense
from .models.rq import Quantizer, mask_and_noise
from .optim.adamw import ClippedAdamW, optim_settings
from .step import (STREAM_AUGMENT, STREAM_DROPOUT, Featurizer, step_seed,
                   take_step)

Batch = Dict[str, Any]
BEST_RQ_KEYS = {"feature_dim", "stack_size", "num_codebooks",
                "codebook_size", "codebook_dim", "distance", "seed",
                "masking"}
MASKING_KEYS = {"mask_proportion", "mean_span_length", "span_distribution",
                "noise_std"}


class SslModel(nn.Module):
    """The encoder and the logits layer, under the port's names."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        enc = config["encoder"]
        if enc["model"] != "Conformer":
            raise ValueError(f"the reference has the Conformer only, not "
                             f"{enc['model']}")
        self.encoder = ConformerRel(from_dict(ConformerRelConfig,
                                              enc.get("config")))
        brq = best_rq_config(config)
        self.num_codebooks = int(brq.get("num_codebooks", 16))
        self.codebook_size = int(brq.get("codebook_size", 8192))
        self.logits_layer = Dense(self.encoder.config.output_dim,
                                  self.num_codebooks * self.codebook_size)


def best_rq_config(config: Dict[str, Any]) -> Dict[str, Any]:
    brq = dict((config.get("ssl") or {}).get("best_rq") or {})
    masking = dict(brq.get("masking") or {})
    for keys, have, what in ((BEST_RQ_KEYS, brq, "ssl.best_rq"),
                             (MASKING_KEYS, masking, "masking")):
        if set(have) - keys:
            raise ValueError(f"{what}: unknown keys "
                             f"{sorted(set(have) - keys)}")
    if masking.get("span_distribution", "static") != "static":
        raise ValueError(f"the reference masks static spans only, not "
                         f"{masking['span_distribution']}")
    if brq.get("distance", "euclidean") not in ("euclidean", "cosine"):
        raise ValueError(f"no distance {brq['distance']}")
    return brq


def _check_task(config: Dict[str, Any]) -> None:
    if config["task"]["type"] != "SSL":
        raise ValueError(f"the reference trains the SSL task only, not "
                         f"{config['task']['type']}")
    loss = dict(config["loss"])
    if loss.get("model") != "MaskedCELoss" or \
            (loss.get("config") or {}).get("label_smoothing", 0.0):
        raise ValueError("the reference's loss is MaskedCELoss without "
                         "label smoothing")
    if loss.get("loss_selection", "mask_loss") not in ("mask_loss", "all"):
        raise ValueError(f"no loss_selection {loss['loss_selection']}")
    if int((config.get("trainer") or {}).get(
            "accumulate_grad_batches", 1) or 1) != 1:
        raise ValueError("the reference takes no gradient accumulation")


def _clip(config: Dict[str, Any]):
    clip = (config.get("trainer") or {}).get("gradient_clip_val")
    return float(clip) if clip else None


def check_config(config: Dict[str, Any]) -> None:
    """Raise where `ReferenceTrainer(config, ...)` would, with no tensor
    work: the config read, the model and featurizer built on the meta
    device."""
    _check_task(config)
    with torch.device("meta"):
        Featurizer(config)
        SslModel(config)
    optim_settings(config["optim_setup"], _clip(config))


def check_traffic(config: Dict[str, Any], traffic: Dict[str, Any]) -> None:
    """Raise unless the mix's audio has the frontend's sample rate and,
    where augmentation mixes noise in, the mix has noise clips."""
    want = int(((config.get("dataset") or {}).get("feat_config") or {})
               .get("sample_rate", 16000))
    if int(traffic["sample_rate"]) != want:
        raise ValueError(f"the mix's audio is at {traffic['sample_rate']} "
                         f"Hz, the frontend reads {want} Hz")
    aug = (config.get("dataset") or {}).get("data_aug_config") or {}
    if (aug.get("use_add_noise") or aug.get("use_mix_feats")) and \
            int((traffic.get("noise") or {}).get("clips", 0)) < 1:
        raise ValueError("augmentation mixes noise in and the mix has no "
                         "noise clips")


class SslTask(Featurizer):
    """The SSL task's training step."""

    def __init__(self, config: Dict[str, Any], device: torch.device):
        super().__init__(config)
        self.model = SslModel(config)
        brq = best_rq_config(config)
        self.masking = dict(brq.get("masking") or {})
        feature_dim = int(brq.get("feature_dim",
                                  self.frontend.cfg.num_mel_bins))
        self.quantizer = Quantizer(brq, feature_dim, device)
        self.mask_loss = config["loss"].get("loss_selection",
                                            "mask_loss") == "mask_loss"

    def step_losses(self, batch: Batch, generators
                    ) -> Callable[[], Dict[str, torch.Tensor]]:
        augment_gen, dropout_gen = generators
        raw, lens = self.featurize(batch)
        auged, _ = self.featurize(batch, augment_gen, training=True)
        labels, lens2 = self.quantizer.labels(raw, lens)
        masked, mask2 = mask_and_noise(self.masking, self.quantizer.stack,
                                       auged, lens2, labels.shape[-1],
                                       augment_gen)

        def losses():
            enc, enc_lens = self.model.encoder(masked, lens, training=True,
                                               generator=dropout_gen)
            logits = self.model.logits_layer(enc).float()
            return {"loss": self.loss(logits, enc_lens, labels, mask2,
                                      lens2)}
        return losses

    def loss(self, logits, enc_lens, labels, mask2, lens2) -> torch.Tensor:
        """The mean CE over codebooks and selected frames of the common
        length T2."""
        B, T, _ = logits.shape
        n, K = self.model.num_codebooks, self.model.codebook_size
        T2 = min(T, labels.shape[-1])
        valid = torch.arange(T2, device=logits.device)[None, :] < \
            torch.minimum(lens2, enc_lens)[:, None]
        sel = valid & mask2[:, :T2] if self.mask_loss else valid
        rows = logits[:, :T2].reshape(B, T2, n, K)[sel]       # (N, n, K)
        want = labels[:, :, :T2].permute(1, 2, 0)[sel]        # (N, n)
        return F.cross_entropy(rows.reshape(-1, K), want.reshape(-1))


class ReferenceTrainer:
    """The model, optimizer and step generators of one training config on
    one device; `write_weights(model)` writes the caller's weights before
    the optimizer is built."""

    def __init__(self, config: Dict[str, Any], seed: int,
                 device: torch.device,
                 write_weights: Callable[[nn.Module], Any]):
        _check_task(config)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.task = SslTask(config, device)
        self.task.to(device)
        self.model = self.task.model
        write_weights(self.model)
        self.seed = seed
        self.optimizer = ClippedAdamW(
            self.model.parameters(),
            **optim_settings(config["optim_setup"], _clip(config)))
        self._gens = (torch.Generator(device), torch.Generator(device))

    def generators(self, step: int):
        for g, stream in zip(self._gens, (STREAM_AUGMENT, STREAM_DROPOUT)):
            g.manual_seed(step_seed(self.seed, step, stream))
        return self._gens

    def train_step(self, batch: Batch, step: int) -> Dict[str, torch.Tensor]:
        return take_step(self.model,
                         self.task.step_losses(batch, self.generators(step)),
                         self.optimizer)
