"""Checkpoint averaging CLI (port of speech2text_tpu/tools/model_average.py):
the uniform average of the best-k checkpoints by the monitored metric
(train/checkpoint.py:average_checkpoints) written as a port checkpoint.

    python -m speech2text_torch.tools.model_average \\
        --checkpoints_dir tasks/<name>/checkpoints [--best_k 5] \\
        [--monitor wer] [--mode min] [--output DIR]

writes DIR (default <checkpoints_dir>/averaged) as a checkpoint
directory of the port holding one checkpoint, step −1 as in the JAX
tool: `step_-0000001.pt` = {"model": the averaged state_dict, "step":
−1} and its `index.json`. `RnntServer(checkpoint=DIR)` and
train/checkpoint.py:inference_weights (`checkpoints_dir: DIR`, latest or
`chkpt_name: -1`) load it.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..train.checkpoint import CheckpointManager, average_checkpoints
from ..utils.logging import get_logger, init_logging


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m speech2text_torch.tools.model_average",
        description="Average the best-k checkpoints of a training run.")
    ap.add_argument("--checkpoints_dir", required=True,
                    help="checkpoint directory with index.json")
    ap.add_argument("--best_k", type=int, default=5,
                    help="number of best checkpoints to average")
    ap.add_argument("--monitor", default="wer", help="metric key")
    ap.add_argument("--mode", default="min", choices=("min", "max"))
    ap.add_argument("--output", default=None,
                    help="output directory (default <dir>/averaged)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Average as the command line says; returns the written file."""
    args = parse_args(argv)
    init_logging()
    model = average_checkpoints(args.checkpoints_dir, best_k=args.best_k,
                                monitor=args.monitor, mode=args.mode)
    out_dir = args.output or os.path.join(args.checkpoints_dir, "averaged")
    mgr = CheckpointManager(out_dir)
    mgr.save(-1, {"model": model, "step": -1})
    get_logger().info("averaged checkpoint → %s", mgr.path(-1))
    return mgr.path(-1)


if __name__ == "__main__":
    main()
