"""The flagship training step (port of bench.py:one_step with the pruned
task's loss, speech2text_tpu/tasks/rnnt.py:335-354).

`TrainStep.from_config(train_config, device="cuda", seed=0)` builds, from
a training YAML (a path or a loaded dict), the fbank frontend and CMVN of
its `dataset`/`callbacks` sections, the model (seeded random weights), the
loss combination of its `loss` section and ScaledAdam with its schedule
from `optim_setup`. `step(pcm, pcm_lens, labels, label_lens)` then runs
featurize (int16 or f32 PCM → fbank through kernel B2 on the card → CMVN;
no dither or augmentation) → the model in training mode (dropout, feature
mask and the chunk drawn for the step) → simple_scale·simple +
pruned_scale·pruned → backward → optimizer step, and returns the three
losses as 0-d tensors on the device (reading them waits for the card).

It runs on `cuda` unless the caller passes `device="cpu"`. Dropout and
feature masks come from a generator on the device, and the chunk choice
from a CPU generator, both seeded with `seed`.

The step's phases are `torch.profiler.record_function` spans, which a
profiler reads and which cost nothing without one: "featurize",
"encoder" and "joiner_losses" (predictor, joiner with the simple loss and
prune ranges, pruned loss; the two model spans are RnntModel.forward's),
"backward" and "optimizer".
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..config import load_config
from ..data.frontend import Fbank, FrontendSetup
from ..models.cmvn import GlobalCmvn
from ..optim import OptimSetup
from ..serve import dequant_pcm
from ..tasks.rnnt import PrunedRnntLossFn, RnntModel, sample_chunk


class TrainStep:

    def __init__(self, config: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        task = (config.get("task") or {}).get("type", "Pruned_Rnnt")
        if task != "Pruned_Rnnt":
            raise NotImplementedError(f"task {task!r} is not ported "
                                      f"(Pruned_Rnnt only)")
        self.device = torch.device(device)
        ds = config.get("dataset") or {}
        self.frontend = FrontendSetup(ds.get("feat_type", "lhotes_fbank"),
                                      ds.get("feat_config") or {})
        if not isinstance(self.frontend, Fbank):
            raise NotImplementedError("only fbank frontends are ported")
        cmvn_cfg = (config.get("callbacks") or {}).get("global_cmvn") or {}
        path = cmvn_cfg.get("pre_compute_cmvn")
        self.cmvn = GlobalCmvn.from_file(path) \
            if cmvn_cfg.get("apply") and path and os.path.exists(path) \
            else GlobalCmvn()
        self.model = RnntModel.from_config(config)
        self.model.init_weights(torch.Generator().manual_seed(seed))
        for m in (self.frontend, self.cmvn, self.model):
            m.to(self.device)
        self.loss_fn = PrunedRnntLossFn(config["loss"])
        self.optimizer, _ = OptimSetup(config["optim_setup"],
                                       self.model.parameters())
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.host_generator = torch.Generator().manual_seed(seed)

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
        with torch.no_grad(), record_function("featurize"):
            feats, lens = self.frontend(dequant_pcm(self._tensor(pcm)),
                                        self._tensor(pcm_lens))
            return self.cmvn(feats), lens

    def step(self, pcm, pcm_lens, labels, label_lens,
             chunk: Optional[Tuple[int, int]] = None
             ) -> Dict[str, torch.Tensor]:
        """One training step; returns {"loss", "simple_loss",
        "pruned_loss"} of the step's forward, before the update.
        `chunk` = (chunk_size, left_context_chunks) fixes the chunk choice;
        by default it is drawn from the encoder config's lists."""
        self.optimizer.zero_grad()
        feats, feat_lens = self.featurize(pcm, pcm_lens)
        labels, label_lens = self._tensor(labels), self._tensor(label_lens)
        cs, lc = chunk if chunk is not None else sample_chunk(
            self.model.encoder.config, self.host_generator)
        out = self.model(feats, feat_lens, labels, label_lens, training=True,
                         generator=self.generator, chunk_size=cs,
                         left_context_chunks=lc)
        with record_function("joiner_losses"):
            losses = self.loss_fn(out, labels, label_lens)
        with record_function("backward"):
            losses["loss"].backward()
        with record_function("optimizer"):
            self.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}
