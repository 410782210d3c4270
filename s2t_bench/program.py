"""The system under test: speech2text_torch's Trainer on one device.

The only module of the benchmark that imports the port. `Program` builds
the port's task of a training config (its TaskFactory), its `Trainer`
(the workdir a temporary directory the caller owns, the seed the run's),
writes the benchmark's weights over the Trainer's own init, builds the
optimizer (`init_state`) and takes steps through `Trainer.train_step`,
the call every training run of the port makes. On a card it first
builds or loads kernels B1 and B2 (the port's nvcc cache under
`build/kernels/` in the checkout). `launches()` reads the port's launch
counters of both kernels.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from .weights import write_weights

KERNEL_COUNTERS = ("attn_weights", "fbank")


def build_kernels() -> None:
    """Compile (first run in a checkout) or load the port's kernels."""
    from speech2text_torch.ops import attn_weights, build, fbank
    build.build([attn_weights.KERNEL, fbank.KERNEL])
    attn_weights.KERNEL.lib()
    fbank.KERNEL.lib()


class Program:

    def __init__(self, train_config: Dict[str, Any], seed: int,
                 device: torch.device, workdir: str):
        from speech2text_torch.tasks.factory import TaskFactory
        from speech2text_torch.train.loop import Trainer
        if device.type == "cuda":
            build_kernels()
        cfg = copy.deepcopy(train_config)
        task = TaskFactory(cfg["task"]["type"])(cfg)
        self.trainer = Trainer(task, cfg, workdir, seed=seed, device=device)
        self.model = self.trainer.model
        write_weights(self.model, seed)
        self.trainer.init_state()
        self.optimizer = self.trainer.optimizer

    def train_step(self, batch: Dict[str, torch.Tensor], step: int
                   ) -> Dict[str, torch.Tensor]:
        return self.trainer.train_step(batch, step)

    @staticmethod
    def launches() -> Dict[str, int]:
        from speech2text_torch.ops import attn_weights, fbank
        return {"attn_weights": attn_weights.KERNEL.launches,
                "fbank": fbank.KERNEL.launches}

    def close(self) -> None:
        self.trainer.close()
