"""The reference training step: the port's Trainer.train_step for the
pruned RNN-T task of the flagship, in plain PyTorch.

A frozen copy of speech2text_torch/tasks/base.py (Featurizer),
tasks/rnnt.py (RnntModel, sample_chunk, PrunedRnntLossFn, train_losses),
train/step.py (take_step) and train/loop.py (step_seed, the step's
generators) with one process, no accumulation, no global-norm clip
(ScaledAdam clips by itself) and no kernels: every module here runs its
plain version. What the flagship's config does not use (CTC, other
encoders, heads and predictors, CMVN statistics, dither) raises.
`ReferenceTrainer(config, seed, device, write_weights)` builds the model
and the optimizer of a training config; `train_step(batch, step)` takes
the step the port's Trainer takes on the same device batch, drawing the
augmentation, dropout and chunk from generators seeded as the Trainer
seeds them. `check_config(config)` raises where ReferenceTrainer would;
`check_traffic(config, traffic)` where a mix's labels lie outside the
model's vocabulary.
The reference of the configurations that name "step"; another reference
may import `Featurizer`, `take_step`, `step_seed` and the STREAM_*
constants from here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import from_dict
from .data import augment
from .data.frontend import FrontendSetup, dequant_pcm, feat_lengths
from .losses import PrunedRnntLoss
from .models.joiner import Joiner, JoinerConfig
from .models.layers import init_parameters
from .models.predictor import StatelessPredictor, StatelessPredictorConfig
from .models.zipformer import Zipformer2, Zipformer2Config
from .optim import OptimSetup, optim_settings

STREAM_AUGMENT, STREAM_DROPOUT, STREAM_CHUNK = 0, 1, 2
Batch = Dict[str, Any]


def step_seed(seed: int, step: int, stream: int) -> int:
    """A 63-bit seed that is a function of (seed, step, stream)."""
    state = np.random.SeedSequence((seed, step, stream)).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def take_step(model: nn.Module,
              losses_fn: Callable[[], Dict[str, torch.Tensor]],
              optimizer) -> Dict[str, torch.Tensor]:
    optimizer.zero_grad()
    losses = losses_fn()
    losses["loss"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}


# ------------------------------------------------------------ featurize
class Featurizer(nn.Module):
    """add_noise → fbank → mix_feats → SpecAugment, every draw from one
    generator in a fixed order."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        ds = config.get("dataset") or {}
        self.frontend = FrontendSetup(ds.get("feat_type", "lhotes_fbank"),
                                      ds.get("feat_config") or {})
        if self.frontend.cfg.dither > 0.0:
            raise ValueError("the reference has no dither")
        if ((config.get("callbacks") or {}).get("global_cmvn")
                or {}).get("apply"):
            raise ValueError("the reference has no CMVN statistics")
        self.aug = dict(ds.get("data_aug_config") or {})

    def sample_augmentation(self, batch: Batch, generator: torch.Generator
                            ) -> Dict[str, augment.Draws]:
        aug = self.aug
        draws: Dict[str, augment.Draws] = {}
        has_noise = "noise_pcm" in batch
        if aug.get("use_add_noise") and has_noise:
            nc = aug.get("add_noise_config") or {}
            draws["add_noise"] = augment.sample_add_noise(
                batch["noise_length"], generator,
                p=float(aug.get("add_noise_proportion", 0.5)),
                min_snr_db=float(nc.get("min_snr_db", 10)),
                max_snr_db=float(nc.get("max_snr_db", 50)))
        cfg = self.frontend.cfg
        if aug.get("use_mix_feats") and has_noise:
            mc = aug.get("mix_feats_config") or {}
            draws["mix_feats"] = augment.sample_mix_feats(
                feat_lengths(cfg, batch["noise_length"]), generator,
                p=float(aug.get("mix_feats_proportion", 0.5)),
                snrs=tuple(mc.get("snrs", (10, 20))))
        if aug.get("use_spec_aug"):
            sc = aug.get("spec_aug_config") or {}
            draws["spec_augment"] = augment.sample_spec_augment(
                feat_lengths(cfg, batch["pcm_length"]), cfg.num_mel_bins,
                generator,
                num_time_masks=int(sc.get("num_time_masks", 2)),
                time_mask_max=int(sc.get("time_mask_max", 50)),
                num_freq_masks=int(sc.get("num_freq_masks", 2)),
                freq_mask_max=int(sc.get("freq_mask_max", 10)))
        return draws

    @torch.no_grad()
    def featurize(self, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  training: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        pcm = dequant_pcm(batch["pcm"])
        pcm_lens = batch["pcm_length"]
        if not training or generator is None:
            return self.frontend(pcm, pcm_lens)
        draws = self.sample_augmentation(batch, generator)
        if "add_noise" in draws:
            pcm = augment.add_noise(pcm, pcm_lens,
                                    dequant_pcm(batch["noise_pcm"]),
                                    batch["noise_length"], draws["add_noise"])
        feats, lens = self.frontend(pcm, pcm_lens)
        if "mix_feats" in draws:
            nfeats, nlens = self.frontend(dequant_pcm(batch["noise_pcm"]),
                                          batch["noise_length"])
            feats = augment.mix_feats(feats, lens, nfeats, nlens,
                                      draws["mix_feats"])
        if "spec_augment" in draws:
            feats = augment.spec_augment(feats, draws["spec_augment"])
        return feats, lens


# ------------------------------------------------------------ pruned RNN-T
def encoder_of(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Zipformer":
        return Zipformer2(Zipformer2Config.from_config(cfg))
    raise ValueError(f"the reference has no encoder {model}")


class RnntModel(nn.Module):

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        if config["predictor"]["model"] != "Stateless":
            raise ValueError("the reference has the stateless predictor only")
        if (config.get("decoder") or {}).get("model", "Identity") != \
                "Identity":
            raise ValueError("the reference has the Identity head only")
        self.encoder = encoder_of(config["encoder"])
        self.predictor = StatelessPredictor(from_dict(
            StatelessPredictorConfig, config["predictor"].get("config") or {}))
        self.joiner = Joiner(from_dict(JoinerConfig, config["joiner"]))

    def forward(self, feats, feat_lens, labels, label_lens, training=False,
                generator=None, chunk_size=-1,
                left_context_chunks=-1) -> Dict[str, torch.Tensor]:
        enc, enc_lens = self.encoder(feats, feat_lens, chunk_size,
                                     left_context_chunks, training=training,
                                     generator=generator)
        pred = self.predictor(labels)
        logits, ranges, simple_loss = self.joiner(enc, enc_lens, pred,
                                                  label_lens, labels)
        return {"enc": enc, "enc_lens": enc_lens, "logits": logits,
                "ranges": ranges, "simple_loss": simple_loss}


def sample_chunk(config: Any,
                 generator: torch.Generator) -> Tuple[int, int]:
    if not getattr(config, "causal", False):
        return -1, -1
    chunks = list(config.chunk_size or [-1])
    lefts = list(config.left_context_frames or [-1])
    if chunks == [-1]:
        return -1, -1
    cs = int(chunks[int(torch.randint(len(chunks), (), generator=generator))])
    lf = int(lefts[int(torch.randint(len(lefts), (), generator=generator))])
    lc = max(lf // max(cs, 1), 1) if lf > 0 and cs > 0 else -1
    return cs, lc


class PrunedRnntLossFn:

    def __init__(self, loss_config: Dict[str, Any]):
        self.simple_scale = float(loss_config.get("simple_loss_scale", 0.5))
        self.pruned_scale = float(loss_config.get("pruned_loss_scale", 0.5))
        self.pruned_loss = PrunedRnntLoss(loss_config.get("config", {}))
        if loss_config.get("enable_ctc", False):
            raise ValueError("the reference has no CTC branch")

    def __call__(self, out, labels, label_lens) -> Dict[str, torch.Tensor]:
        pruned = self.pruned_loss({"logits": out["logits"],
                                   "ranges": out["ranges"],
                                   "logits_length": out["enc_lens"],
                                   "label": labels,
                                   "label_length": label_lens})
        simple = out["simple_loss"]
        return {"loss": self.simple_scale * simple
                + self.pruned_scale * pruned,
                "simple_loss": simple, "pruned_loss": pruned}


class RnntTask(Featurizer):
    """The pruned RNN-T task's training step."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        if config["joiner"].get("prune_range", -1) <= 0:
            raise ValueError("the reference trains the pruned RNN-T only")
        self.model = RnntModel(config)
        self.loss = PrunedRnntLossFn(config["loss"])

    def step_losses(self, batch: Batch, step: int, generators
                    ) -> Callable[[], Dict[str, torch.Tensor]]:
        augment_gen, dropout_gen, chunk_gen = generators
        feats, feat_lens = self.featurize(batch, augment_gen, training=True)

        def losses():
            chunk = sample_chunk(self.model.encoder.config, chunk_gen)
            out = self.model(feats, feat_lens, batch["label"],
                             batch["label_length"], training=True,
                             generator=dropout_gen, chunk_size=chunk[0],
                             left_context_chunks=chunk[1])
            result = self.loss(out, batch["label"], batch["label_length"])
            result["frames"] = out["enc_lens"].sum()
            return result
        return losses


def _check_task(config: Dict[str, Any]) -> None:
    task = config["task"]["type"]
    if task != "Pruned_Rnnt":
        raise ValueError(f"the reference trains the pruned RNN-T only, "
                         f"not the task {task}")


def check_config(config: Dict[str, Any]) -> None:
    """Raise where `ReferenceTrainer(config, ...)` would, without its
    memory or its time: the task built on the meta device, the
    optimizer's settings read. (Computing on the meta device, as
    ScaledAdam's set-up would, imports torch._dynamo: seconds.)"""
    _check_task(config)
    with torch.device("meta"):
        RnntTask(config)
    optim_settings(config["optim_setup"])


def check_traffic(config: Dict[str, Any], traffic: Dict[str, Any]) -> None:
    """Raise unless the token ids that the traffic mix draws lie in the
    vocabulary of the predictor and the joiner, blank (0) left out."""
    lo, hi = traffic["vocab"]
    vocab = config["joiner"]["output_dim"]
    symbols = config["predictor"]["config"]["num_symbols"]
    if symbols != vocab:
        raise ValueError(f"the predictor has {symbols} symbols, the "
                         f"joiner {vocab} outputs")
    if not 1 <= lo <= hi < vocab:
        raise ValueError(f"token ids [{lo}, {hi}] do not lie in [1, "
                         f"{vocab - 1}]")


class ReferenceTrainer:
    """The model, optimizer and step generators of one training config on
    one device; `write_weights(model)` writes the caller's weights before
    the optimizer is built."""

    def __init__(self, config: Dict[str, Any], seed: int,
                 device: torch.device,
                 write_weights: Callable[[nn.Module], Any]):
        _check_task(config)
        self.task = RnntTask(config)
        # the constant leaves (biases, norms, bypass scales) as the port
        # sets them; the caller writes every other leaf
        init_parameters(self.task.model, torch.Generator().manual_seed(0))
        self.task.to(device)
        self.model = self.task.model
        write_weights(self.model)
        self.seed = seed
        self.device = device
        self.optimizer, _ = OptimSetup(config["optim_setup"],
                                       self.model.parameters())
        self._gens = (torch.Generator(device), torch.Generator(device),
                      torch.Generator())

    def generators(self, step: int):
        for g, stream in zip(self._gens, (STREAM_AUGMENT, STREAM_DROPOUT,
                                          STREAM_CHUNK)):
            g.manual_seed(step_seed(self.seed, step, stream))
        return self._gens

    def train_step(self, batch: Batch, step: int) -> Dict[str, torch.Tensor]:
        return take_step(self.model,
                         self.task.step_losses(batch, step,
                                               self.generators(step)),
                         self.optimizer)
