"""Checkpoints: top-k by a monitored metric, resume, averaging (port of
speech2text_tpu/train/checkpoint.py with torch files in place of orbax).

Each checkpoint is one `torch.save` file `step_%08d.pt` holding CPU
tensors: {"model": state_dict, "optimizer": the optimizer's state_dict()
(ScaledAdam's buffers, the clipping norms' buffer and the host step
count; Adam's or AdamW's moments and update count), "step", "seed"}.
The per-step generators are functions of (seed, step), so seed and step
restore them. `index.json` has the JAX package's schema,
{"checkpoints": {step: {metric: value}}}, and pruning keeps the same
steps: the `save_top_k` best by `monitor` (ties to the later step) and
always the latest. Files are loaded with `weights_only=True`.
`inference_weights` selects the weights an inference config asks for
(averaged, named or latest), as inference.py does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.logging import get_logger

log = get_logger(__name__)


class CheckpointManager:
    """Top-k checkpoint manager over {model, optimizer, step, seed}."""

    def __init__(self, directory: str, save_top_k: int = 10,
                 monitor: str = "wer", mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: Dict[str, Any] = {"checkpoints": {}}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Write `state` (CPU tensors) for `step`, then the index."""
        path = self.path(step)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        self._index["checkpoints"][str(step)] = dict(metrics or {})
        self._prune()
        with open(self._index_path + ".tmp", "w") as f:
            json.dump(self._index, f, indent=1)
        os.replace(self._index_path + ".tmp", self._index_path)

    def _prune(self) -> None:
        ckpts = self._index["checkpoints"]
        if len(ckpts) <= self.save_top_k:
            return
        sign = 1.0 if self.mode == "min" else -1.0
        latest = max(int(s) for s in ckpts)

        def score(item):
            s, m = item
            v = m.get(self.monitor)
            if v is None:
                v = 0.0 if self.mode == "max" else float("inf")
            # ties go to the later checkpoint: on a flat monitor the
            # earliest checkpoints are the least trained
            return (sign * v, -int(s))

        ranked = sorted(ckpts.items(), key=score)
        keep = {s for s, _ in ranked[:self.save_top_k]}
        keep.add(str(latest))  # always keep latest for resume
        for s in list(ckpts):
            if s not in keep:
                del ckpts[s]
                path = self.path(int(s))
                if os.path.exists(path):
                    os.remove(path)

    def latest_step(self) -> Optional[int]:
        ckpts = self._index["checkpoints"]
        return max((int(s) for s in ckpts), default=None)

    def best_steps(self, k: Optional[int] = None) -> List[int]:
        ckpts = self._index["checkpoints"]
        sign = 1.0 if self.mode == "min" else -1.0
        ranked = sorted(
            ((s, m) for s, m in ckpts.items() if self.monitor in m),
            key=lambda kv: (sign * kv[1][self.monitor], -int(kv[0])))
        steps = [int(s) for s, _ in ranked]
        return steps[:k] if k else steps

    def restore(self, step: int) -> Dict[str, Any]:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        step = self.latest_step()
        if step is None:
            return None
        log.info("restoring checkpoint step %d", step)
        return step, self.restore(step)


def average_checkpoints(directory: str, best_k: int = 5,
                        monitor: str = "wer",
                        mode: str = "min") -> Dict[str, torch.Tensor]:
    """Uniform average of the best-k checkpoints' model weights (the
    latest alone when none carries `monitor`), accumulated in float64 and
    returned in each tensor's dtype."""
    mgr = CheckpointManager(directory, monitor=monitor, mode=mode)
    steps = mgr.best_steps(best_k)
    if not steps:
        latest = mgr.latest_step()
        if latest is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        steps = [latest]
    log.info("averaging %d checkpoints: %s", len(steps), steps)
    acc: Dict[str, torch.Tensor] = {}
    first: Dict[str, torch.Tensor] = {}
    for step in steps:
        model = mgr.restore(step)["model"]
        for k, v in model.items():
            if k not in first:
                first[k] = v
                acc[k] = v.double() if v.is_floating_point() else v
            elif v.is_floating_point():
                acc[k] = acc[k] + v.double()
    return {k: (acc[k] / len(steps)).to(first[k].dtype)
            if first[k].is_floating_point() else acc[k] for k in acc}


def inference_weights(task_section: Dict[str, Any],
                      train_config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The model weights an inference config's `task` section selects
    (inference.py): the average of the best `aver_best_k` (default 5) by
    `wer` with `chkpt_aver`, else step `chkpt_name`, else the latest;
    ranked by `max` when `descending`, else `min`. The directory is
    `checkpoints_dir`, by default `<export_path>/<name>/checkpoints` of
    the training config's `task`."""
    train_task = train_config["task"]
    directory = task_section.get("checkpoints_dir") or os.path.join(
        train_task["export_path"], train_task["name"], "checkpoints")
    mode = "max" if task_section.get("descending") else "min"
    if task_section.get("chkpt_aver"):
        return average_checkpoints(
            directory, best_k=int(task_section.get("aver_best_k", 5)),
            mode=mode)
    mgr = CheckpointManager(directory, mode=mode)
    step = task_section.get("chkpt_name") or mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    log.info("checkpoint step %s of %s", step, directory)
    return mgr.restore(int(step))["model"]
