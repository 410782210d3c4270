"""Operation and byte counts of the training step, from a training
config and a batch's shapes alone (no program code): the model FLOPs of
a step (`step_flops`), the least time of kernels B1 and B2 on a card
(`kernels.py`), and the card's published peaks (`peaks.py`).

FLOPs count the matrix products and convolutions of the forward pass at
2 per multiply-add, over the padded batch, with every attention product
over the whole (T, T) square (what the mask leaves out is still
computed); elementwise work, norms, softmax and the lattice recursions
are not counted. Training takes 3× the forward of the trained modules
(the backward's two products per forward product). Recompute is not
counted.
"""

from __future__ import annotations

from typing import Any, Dict

from . import zipformer


def step_flops(config: Dict[str, Any], batch: int, pcm_len: int,
               label_len: int) -> float:
    """Model FLOPs of one training step of `config` (a training config
    tree) on a batch of (batch, pcm_len) samples and label_len labels."""
    task = config["task"]["type"]
    enc = config["encoder"]
    if task == "Pruned_Rnnt" and enc["model"] == "Zipformer":
        return 3.0 * zipformer.rnnt_forward_flops(config, batch, pcm_len,
                                                  label_len)
    raise ValueError(f"no FLOP count for task {task} with {enc['model']}")
