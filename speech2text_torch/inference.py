"""Inference entry point of the port (port of the repo's inference.py).

    python -m speech2text_torch.inference \\
      --inference_config=configs/inference/<x>.yaml \\
      [--override a.b.c=value ...] [--device cpu]

Reads the inference YAML and the training YAML it names
(`task.train_config`), applied to each other as inference.py applies them
(`inference_train_config`, shared with serve.RnntServer), builds the task,
loads the weights the `task` section selects (train/checkpoint.py:
inference_weights: averaged, named or latest port checkpoint), decodes the
test set (`make_test_pipeline` → `eval_forward` → `eval_hyps`) and writes
to `task.export_path`: `inference.log` and `test_report.txt`, one
utt/hyp/ref/wer block per row of each test batch (the bucketed pipeline
tops a bucket's last batch up with repeats, as the JAX package's does)
and the corpus WER, in inference.py's format.

Runs on `cuda` unless `--device cpu` or the YAML's `task.platform: cpu`
asks for the CPU; with no CUDA device and no such request it raises.
All five of JAX's decode entries are ported: `pruned_rnnt_inference`,
`rnnt_inference`, `ctc_hybrid_rnnt_inference` (decoded by the
transducer, as JAX's), `ctc_inference` and `cif_inference` (the CIF
task's free pass, `cif_greedy_search`); the `decoding` section's type and
config, such as `beam_size` and `cand_size`, go into the training
config's `metric` (so `--override decoding.config.int8=true` decodes a
transducer with the int8 predictor and joiner). With `task.module_export`
a transducer's encoder, predictor step and joiner step are exported
before the test loop (export.py: `encoder.pt2`, `predictor.pt2`,
`joiner.pt2`, at `module_export_config.max_frames`, default 2000) with
`units.txt` and, unless `module_export_config.export_int8` is false,
`weights.int8.npz`, into `task.export_path`. With `task.onnx_export` the
same trio and a Zipformer2's streaming encoder are written as ONNX graphs
(export.py:export_onnx_modules: `encoder.onnx`, `predictor.onnx`,
`joiner.onnx`, `encoder_stream.onnx` with `encoder_stream_spec.json`,
`units.txt` and, unless `onnx_export_config.export_int8` is false, the
`*_int8.onnx` variants; the encoder at
`onnx_export_config.onnx_encoder_config.max_frames`, default 2000), also
after the weights are loaded and before the test loop.

Over N GPUs (`python -m torch.distributed.run --nproc_per_node N -m
speech2text_torch.inference ...`, parallel/mesh.py) the test set is
sharded as JAX's inference.py shards it over its mesh: test batches are
rounded up to a multiple of N rows (`batch_multiple`), every rank decodes
its slice of each batch, and rank 0 gathers the hypotheses and writes
the report and the WER in the order of one process, the same bytes as
JAX's on a mesh of N devices. Rank 0 alone writes files (the log, the
exports, the report); every rank returns the same WER.
"""

from __future__ import annotations

import argparse
import copy
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import parallel
from .config import load_config, override
from .convert import to_flax
from .export import (export_asr_modules, export_onnx_modules,
                     save_quantized)
from .metrics import AsrMetric, word_error_rate
from .tasks.factory import TaskFactory
from .tasks.rnnt import TransducerTask
from .train.checkpoint import inference_weights
from .train.loop import resolve_device
from .utils.logging import get_logger, init_logging

REPO_ROOT = Path(__file__).resolve().parents[1]

_INFER_TO_TRAIN = {
    "ctc_inference": "CTC",
    "rnnt_inference": "Rnnt",
    "ctc_hybrid_rnnt_inference": "CTC_Hybrid_Rnnt",
    "pruned_rnnt_inference": "Pruned_Rnnt",
    "cif_inference": "CIF",
}


def _resolve(path: str) -> str:
    """A config path as given, else relative to the repo root."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return str(REPO_ROOT / path)


def inference_train_config(infer_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The training config an inference config runs (`task.train_config`,
    a path or a loaded config dict), with what inference.py applies to
    it: the subword model's path under the training run's `spm/` when the
    YAML names none, the test set's `test_data` (default: the eval data),
    `feat_type` (kept for a PCM-trained task) and `num_mel_bins`, the
    `decoding` section into `metric`, and `streaming.is_encoder_streaming`
    as `metric.encoder_streaming`."""
    train_cfg = infer_cfg["task"]["train_config"]
    train_cfg = copy.deepcopy(train_cfg) if isinstance(train_cfg, dict) \
        else load_config(_resolve(train_cfg))
    tok = train_cfg.get("tokenizer") or {}
    if tok.get("type") == "subword" and not (tok.get("config") or {}).get(
            "spm_model"):
        spm = os.path.join(train_cfg["task"]["export_path"],
                           train_cfg["task"]["name"], "spm")
        tok["config"] = dict(tok.get("config") or {},
                             spm_model=os.path.join(spm, "tokenizer.model"),
                             spm_vocab=os.path.join(spm, "tokenizer.vocab"))
    testset = infer_cfg.get("testset") or {}
    ds = train_cfg.setdefault("dataset", {})
    ds["test_data"] = testset.get("test_data", ds.get("eval_data"))
    ts_cfg = testset.get("config") or {}
    if "feat_type" in ts_cfg and not ts_cfg["feat_type"].startswith(
            "torchscript") and ds.get("feat_type") != "pcm":
        ds["feat_type"] = ts_cfg["feat_type"]
    if "num_mel_bins" in (ts_cfg.get("feat_config") or {}):
        ds.setdefault("feat_config", {})["num_mel_bins"] = \
            ts_cfg["feat_config"]["num_mel_bins"]
    dec = infer_cfg.get("decoding") or {}
    if dec.get("type"):
        metric = train_cfg.setdefault("metric", {})
        metric["decode_method"] = dec["type"]
        metric.update(dec.get("config") or {})
    if (infer_cfg.get("streaming") or {}).get("is_encoder_streaming"):
        train_cfg.setdefault("metric", {})["encoder_streaming"] = True
    return train_cfg


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m speech2text_torch.inference",
        description="Decode a test set with a task of the port.")
    ap.add_argument("--inference_config", required=True,
                    help="YAML of the inference setup")
    ap.add_argument("--override", action="append", default=[],
                    metavar="A.B=V", help="dotted-key config override")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; the YAML's task.platform "
                         "when not given")
    return ap.parse_args(argv)


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (lists of strings
    dropped)."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def prepare(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Everything before the test loop: {"task" (with its weights, on the
    device), "device", "workdir", "infer_config", "train_config"}."""
    args = parse_args(argv)
    infer_cfg = load_config(_resolve(args.inference_config))
    for ov in args.override:
        key, _, value = ov.partition("=")
        override(infer_cfg, key, value)
    section = infer_cfg["task"]
    device = parallel.setup(resolve_device(
        args.device, {"platform": section.get("platform")}))
    task_type = _INFER_TO_TRAIN[section["type"]]
    task_cls = TaskFactory(task_type)

    workdir = section["export_path"]
    os.makedirs(workdir, exist_ok=True)
    init_logging(os.path.join(workdir, "inference.log")
                 if parallel.is_main() else None)
    train_cfg = inference_train_config(infer_cfg)
    task = task_cls(train_cfg)
    task.model.load_state_dict(inference_weights(section, train_cfg))
    task.to(device).eval()
    get_logger().info("task %s, %d labels, weights from %s, device %s",
                      task_type, len(task.tokenizer),
                      section.get("checkpoints_dir") or "the training run",
                      device)
    if section.get("module_export") and parallel.is_main():
        module_export(task, workdir,
                      infer_cfg.get("module_export_config") or {})
    if section.get("onnx_export") and parallel.is_main():
        onnx_cfg = infer_cfg.get("onnx_export_config") or {}
        enc_cfg = onnx_cfg.get("onnx_encoder_config") or {}
        export_onnx_modules(task, workdir,
                            max_frames=int(enc_cfg.get("max_frames", 2000)),
                            int8=bool(onnx_cfg.get("export_int8", True)))
    parallel.barrier()
    return {"task": task, "device": device, "workdir": workdir,
            "infer_config": infer_cfg, "train_config": train_cfg}


def module_export(task, workdir: str, config: Dict[str, Any]) -> None:
    """The deployment files of `task.module_export` (inference.py:127-136
    of the JAX package), written into `workdir`."""
    if not isinstance(task, TransducerTask):
        raise NotImplementedError(f"task.module_export exports a "
                                  f"transducer, not {type(task).__name__}")
    export_asr_modules(task, workdir,
                       max_frames=int(config.get("max_frames", 2000)))
    task.tokenizer.export_units(os.path.join(workdir, "units.txt"))
    if config.get("export_int8", True):
        save_quantized(to_flax(task.model),
                       os.path.join(workdir, "weights.int8.npz"))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Decode the test set as the command line says; returns prepare()'s
    dict with "report" (the path of test_report.txt), "wer" (corpus WER),
    "num_utts" and "batches"."""
    run = prepare(argv)
    task, device = run["task"], run["device"]
    world = parallel.world_size()
    # JAX's inference.py:156-157: batches divisible by the data axis
    task.data_config.batch_multiple = world
    rows: List[List[tuple]] = []      # per batch: (utt, hyp, ref) rows
    for batch in task.make_test_pipeline(parallel.rank(), world):
        out = task.eval_forward(to_device(batch, device), losses=False)
        rows.append(list(zip(batch["audio_filepath"], task.eval_hyps(out),
                             batch["text"])))
    if world > 1:
        # rank r holds rows r, r + N, ... of each batch (BucketBatcher)
        shards = parallel.all_gather_object(rows)
        rows = [[shards[i % world][b][i // world]
                 for i in range(world * len(rows[b]))]
                for b in range(len(rows))]
    metric = AsrMetric()
    report_path = os.path.join(run["workdir"], "test_report.txt")
    lines = []
    for batch_rows in rows:
        for utt, hyp, ref in batch_rows:
            wer = word_error_rate([hyp], [ref])
            lines.append(f"utt: {utt}\nhyp: {hyp}\nref: {ref}\n"
                         f"wer: {wer:.4f}\n\n")
        metric.update([r[1] for r in batch_rows], [r[2] for r in batch_rows])
    corpus_wer = metric.compute()
    lines.append(f"corpus wer: {corpus_wer:.4f} ({metric.num_utts} utts)\n")
    if parallel.is_main():
        with open(report_path, "w") as report:
            report.write("".join(lines))
        get_logger().info("corpus WER %.4f over %d utts → %s", corpus_wer,
                          metric.num_utts, report_path)
    parallel.barrier()
    return dict(run, report=report_path, wer=corpus_wer,
                num_utts=metric.num_utts, batches=len(rows))


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.shutdown()
