"""The training step (port of bench.py:one_step with a transducer task's
loss, speech2text_tpu/tasks/rnnt.py, and of the train step of
speech2text_tpu/train/loop.py).

`take_step` is the step's body, shared by `TrainStep` and
train/loop.py's Trainer for every task: the task's training losses (a
callable: the model in training mode → its loss combination) →
backward → gradient norm → optionally optax's global-norm clipping
(`trainer.gradient_clip_val` for an optimizer other than ScaledAdam,
which clips by itself) → optimizer step, returning the losses, the
gradient norm before clipping and the frames as 0-d tensors on the
device (reading them waits for the card).

`TrainStep.from_config(train_config, device="cuda", seed=0)` builds, from
a transducer training YAML (a path or a loaded dict; `task.type`
Pruned_Rnnt, Rnnt or CTC_Hybrid_Rnnt; a Zipformer2 or a Conformer
encoder, an Identity or Projector head, a Stateless or LSTM predictor,
the CTC branch of `loss.enable_ctc`), the featurizer of its
`dataset`/`callbacks` sections (tasks/base.py), the model (seeded random
weights), the loss combination of its task (tasks/rnnt.py:loss_fn_of)
and the optimizer with its schedule from `optim_setup`, with no
tokenizer or data pipeline. `step(pcm, pcm_lens, labels, label_lens)`
featurizes (int16 or f32 PCM → fbank through kernel B2 on the card →
CMVN; no dither or augmentation) and takes the step on caller-made
tensors, at the global step it counts from 0 (the one a Zipformer2's
training dynamics read).

It runs on `cuda` unless the caller passes `device="cpu"`. Dropout and
feature masks come from a generator on the device, and the chunk choice
from a CPU generator, both seeded with `seed`.

The step's phases are spans (utils/tracing.py: a profiler reads them,
and the recorder, when on, keeps them on the profiler's clock):
"featurize", "encoder" (with the decoder head), "joiner_losses" (twice:
predictor and joiner, in RnntModel.forward, with "simple_loss" and
"prune_ranges" inside; then the task's losses, with "pruned_loss" and
"ctc_loss" inside, or "rnnt_loss" for the full-lattice loss),
"backward" (inside it "attn_weights_backward", B1's backward, once per
attention layer; with the training dynamics "regularizers_backward", the
balancers' and whitening's extra gradients; with the recorder on,
"pruned_loss_backward", the pruned lattice's backward; on the card the
three run on autograd's device thread) and "optimizer" (with the
gradient norm and the clipping).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import load_config
from ..optim import OptimSetup, clip_by_global_norm_
from ..parallel import grad_norm as global_grad_norm
from ..tasks.base import Featurizer
from ..tasks.rnnt import RnntModel, loss_fn_of, sample_chunk, train_losses
from ..utils.tracing import span


def clip_value(config: Dict[str, Any]) -> Optional[float]:
    """The global-norm clip of a training config: `trainer.
    gradient_clip_val` unless the optimizer is ScaledAdam (train/loop.py
    of the JAX package chains optax.clip_by_global_norm before every
    other optimizer)."""
    clip = (config.get("trainer") or {}).get("gradient_clip_val")
    if not clip or config["optim_setup"]["optimizer"]["type"] == \
            "ScaledAdam":
        return None
    return float(clip)


def take_step(model: torch.nn.Module,
              losses_fn: Callable[[], Dict[str, torch.Tensor]],
              optimizer, clip: Optional[float] = None
              ) -> Dict[str, torch.Tensor]:
    """One optimizer step of `model`: `losses_fn()` (the training
    forward; a dict with "loss", the other losses and "frames"),
    backward, the gradient norm, clipping to `clip` by optax's rule, the
    optimizer. Returns the losses, "grad_norm" (before clipping) and
    "frames" as 0-d tensors on the device. Under DDP the gradients are
    the ranks' average when backward returns, and under FSDP their shards
    (parallel/mesh.py): the norm and the clipping are the global
    gradient's."""
    optimizer.zero_grad()
    losses = losses_fn()
    with span("backward"):
        losses["loss"].backward()
    with span("optimizer"):
        with torch.no_grad():
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            grad_norm = global_grad_norm(grads)
            if clip is not None:
                clip_by_global_norm_(grads, clip, grad_norm)
        optimizer.step()
    return {**{k: v.detach() for k, v in losses.items()},
            "grad_norm": grad_norm}


class TrainStep:

    def __init__(self, config: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.loss_fn = loss_fn_of(
            (config.get("task") or {}).get("type", "Pruned_Rnnt"), config)
        self.device = torch.device(device)
        self.features = Featurizer(config)
        self.model = RnntModel.from_config(config)
        self.model.init_weights(torch.Generator().manual_seed(seed))
        for m in (self.features, self.model):
            m.to(self.device)
        self.optimizer, _ = OptimSetup(config["optim_setup"],
                                       self.model.named_parameters())
        self.clip = clip_value(config)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.global_step = 0

    @classmethod
    def from_config(cls, train_config: Union[str, Dict[str, Any]],
                    device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> "TrainStep":
        cfg = load_config(train_config) if isinstance(train_config, str) \
            else copy.deepcopy(train_config)
        return cls(cfg, device=device, seed=seed)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(self.device)

    def featurize(self, pcm, pcm_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        """tasks/base.py's featurize, without augmentation."""
        return self.features.featurize({"pcm": self._tensor(pcm),
                                        "pcm_length": self._tensor(pcm_lens)})

    def step(self, pcm, pcm_lens, labels, label_lens,
             chunk: Optional[Tuple[int, int]] = None
             ) -> Dict[str, torch.Tensor]:
        """One training step; returns take_step's {"loss", the task's
        other losses, "grad_norm", "frames"}, the losses of the step's
        forward, before the update. `chunk` =
        (chunk_size, left_context_chunks) fixes the chunk choice; by
        default it is drawn from the encoder config's lists."""
        feats, feat_lens = self.featurize(pcm, pcm_lens)
        labels, label_lens = self._tensor(labels), self._tensor(label_lens)
        if chunk is None:
            chunk = sample_chunk(self.model.encoder.config,
                                 self.host_generator)
        step = self.global_step
        self.global_step += 1
        return take_step(
            self.model,
            lambda: train_losses(self.model, self.loss_fn, feats, feat_lens,
                                 labels, label_lens, chunk, self.generator,
                                 step),
            self.optimizer, self.clip)
