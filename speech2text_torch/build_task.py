"""Training entry point of the port (port of the repo's build_task.py).

    python -m speech2text_torch.build_task \\
      --training_config=configs/training/zipformer_stateless_pruned_rnnt.yaml \\
      [--override a.b.c=value ...] [--max_steps N] [--device cpu]

YAML → the task of `task.type` (`Pruned_Rnnt`, `Rnnt`,
`CTC_Hybrid_Rnnt`: tasks/rnnt.py; `CTC`: tasks/ctc.py; `CIF`:
tasks/cif.py; `SSL`: tasks/ssl.py; `NNLM`: tasks/nnlm.py) → Trainer.fit,
in `<task.export_path>/<task.name>`:
seeds, `run.log`, the subword model trained from the train manifest
(tools/spm_train.py), a backup of the resolved config (written with
config.dumps, read back by config.load_config), finetuning from a port
checkpoint file or an averaged top-k directory (`finetune.base_model`:
the tensors whose name and shape match are copied, such as an SSL
checkpoint's encoder into a CTC task; the count is logged),
and resume from the run's latest checkpoint or from `resume` (also
after the host-RSS watchdog's exec-restart, `trainer.max_rss_gb`).
With `callbacks.global_cmvn.apply` and no statistics file yet
(`pre_compute_cmvn`, else `<workdir>/cmvn.json`), the global CMVN
statistics are computed as the JAX package's build_task computes them:
up to `CMVN_BATCHES` train batches featurized by the task's frontend
(kernel B2 on the card), accumulated in f64 on the host, written in the
JAX package's JSON format and loaded.

Runs on `cuda` unless `--device cpu` or the YAML's `trainer.platform:
cpu` asks for the CPU; with no CUDA device and no such request it raises
before it writes anything. With `callbacks.frontend_save` the fbank
frontend is exported on that device as `<workdir>/frontend.pt2`
(export.py:export_frontend, B=1 × 30 s), as the JAX package's
build_task exports it before training.

Over N GPUs: `python -m torch.distributed.run --standalone
--nproc_per_node N -m speech2text_torch.build_task ...` (the Trainer's
data parallelism and `trainer.fsdp`: train/loop.py). The process group
is made first; rank 0 alone writes files (the run log, the subword
model, the config backup, cmvn.json, frontend.pt2), and the other ranks
wait for it and then read what it wrote.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import parallel
from .config import dumps, load_config, override
from .data.frontend import dequant_pcm
from .export import export_frontend
from .models.cmvn import GlobalCmvn, compute_cmvn_stats
from .tasks.base import Featurizer
from .tasks.factory import TaskFactory
from .tools.spm_train import spm_training_preprocess
from .train.checkpoint import average_checkpoints
from .train.loop import Trainer, resolve_device
from .utils.logging import get_logger, init_logging

CMVN_BATCHES = 200


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m speech2text_torch.build_task",
        description="Train a task of the port from a training YAML.")
    ap.add_argument("--training_config", required=True,
                    help="YAML of the training setup")
    ap.add_argument("--override", action="append", default=[],
                    metavar="A.B=V", help="dotted-key config override")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="optional step cap")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; the YAML's "
                         "trainer.platform when not given")
    return ap.parse_args(argv)


def load_finetune(ft: Dict[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """`finetune.base_model`: a checkpoint directory (index.json) → the
    average of its best `best_k`; a checkpoint file → its weights."""
    base = ft.get("base_model")
    if not base:
        return None
    if os.path.isdir(base) and os.path.exists(
            os.path.join(base, "index.json")):
        return average_checkpoints(base, best_k=int(ft.get("best_k", 5)))
    return torch.load(base, map_location="cpu", weights_only=True)["model"]


def cmvn_feature_batches(task: Featurizer, device: torch.device):
    """(feats, lengths) as numpy of the first `CMVN_BATCHES` batches of
    the task's train pipeline (its default seed, as the JAX package's),
    featurized by the frontend alone (no augmentation) on `device`."""
    task.frontend.to(device)
    it = iter(task.make_train_pipeline())
    try:
        for _, batch in zip(range(CMVN_BATCHES), it):
            with torch.no_grad():
                feats, lens = task.frontend(
                    dequant_pcm(torch.from_numpy(batch["pcm"]).to(device)),
                    torch.from_numpy(batch["pcm_length"]).to(device))
            yield feats.cpu().numpy(), lens.cpu().numpy()
    finally:
        it.close()


def prepare(argv: Optional[List[str]] = None
            ) -> Tuple[Trainer, Dict[str, Any]]:
    """Everything before `Trainer.fit`: returns the trainer and fit's
    keyword arguments."""
    args = parse_args(argv)
    config = load_config(args.training_config)
    for ov in args.override:
        key, _, value = ov.partition("=")
        override(config, key, value)
    trainer_cfg = config.get("trainer") or {}
    device = parallel.setup(resolve_device(args.device, trainer_cfg))
    main_rank = parallel.is_main()

    task_section = config["task"]
    task_cls = TaskFactory(task_section["type"])
    cb = config.get("callbacks") or {}

    workdir = os.path.join(task_section["export_path"], task_section["name"])
    os.makedirs(workdir, exist_ok=True)
    init_logging(os.path.join(workdir, "run.log") if main_rank else None)
    log = get_logger()
    seed = int(config.get("seed", 1234))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    if main_rank:
        config = spm_training_preprocess(config)
        # the resolved config (after the tokenizer rewrite) beside the run
        with open(os.path.join(workdir, os.path.basename(
                args.training_config)), "w") as f:
            f.write(dumps(config))
    config = parallel.broadcast_object(config)
    task = task_cls(config)
    log.info("task %s (%s): vocab=%d, device %s", task_section["name"],
             task_section["type"], len(task.tokenizer), device)
    cmvn_cb = cb.get("global_cmvn") or {}
    if cmvn_cb.get("apply") and isinstance(task, Featurizer) and \
            task.cmvn.mean is None:
        path = cmvn_cb.get("pre_compute_cmvn") or os.path.join(workdir,
                                                               "cmvn.json")
        if main_rank and not os.path.exists(path):
            log.info("computing global CMVN over the train set ...")
            compute_cmvn_stats(cmvn_feature_batches(task, device)).save(path)
        parallel.barrier()
        task.cmvn = GlobalCmvn.from_file(path)
        log.info("global CMVN loaded from %s", path)
    if cb.get("frontend_save") and main_rank:
        export_frontend(task.frontend.to(device), workdir)
    parallel.barrier()
    finetune_state = load_finetune(config.get("finetune") or {})
    trainer = Trainer(task, config, workdir, seed=seed, device=device)
    return trainer, dict(resume=config.get("resume"),
                         finetune_state=finetune_state,
                         max_steps=args.max_steps)


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Train as the command line says; returns the Trainer it ran (its
    `last_eval`, `history` and checkpoints)."""
    trainer, fit_kwargs = prepare(argv)
    try:
        result = trainer.fit(**fit_kwargs)
    finally:
        trainer.close()
    get_logger().info("training done: %s", result)
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.shutdown()
