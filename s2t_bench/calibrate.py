"""Readings that the check's limits are set from, on the card at a
cell's own sizes, several seeds in one process:

    python3 -m s2t_bench.calibrate --workload <cell> --seeds 1 2 3 \
        --kinds program control half_batch [--out FILE]

For each seed the reference's readings of the checked steps are taken
once, then each kind's, and the three numbers of check.py between them:
`program` the port (the lower reading), `control` the reference one
precision lower in the program's place (check.lower_precision), and
`half_batch` the reference fed the first half of each batch's rows, the
mean taken over them. (A step that leaves its state unchanged reads
change_gap 1 by the measure itself.) One JSON line per seed and kind
goes to standard output and to FILE. The reference is the module that
the cell's configuration file names (cell.Cell.reference), found and
given the configuration before any work on the card; the cell needs no
check limits yet.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time

import torch

from .bench import set_precision
from .cell import load_cell
from .check import CHECKED_STEPS, checked_steps, compare, lower_precision
from .program import Program
from .weights import write_weights
from .workload import NoisePool, Traffic, make_batch


def half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def readings(cell, seed: int, kind: str, device: torch.device,
             batch_of):
    cfg = cell.train_config
    if kind == "program":
        with tempfile.TemporaryDirectory(prefix="s2t_bench_") as wd:
            prog = Program(cfg, seed, device, wd)
            got = checked_steps(prog.model, prog.train_step, batch_of,
                                "train_loss")
            prog.close()
            del prog
    else:
        feed = (lambda i: half(batch_of(i))) if kind == "half_batch" \
            else batch_of
        ref = cell.part("reference").ReferenceTrainer(
            cfg, seed, device, lambda m: write_weights(m, seed))
        if kind == "control":
            with lower_precision(device):
                got = checked_steps(ref.model, ref.train_step, feed, "loss")
        else:
            got = checked_steps(ref.model, ref.train_step, feed, "loss")
        del ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["program"],
                    choices=["program", "control", "half_batch"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    cell.reference()
    set_precision(cell.meta)
    sampler = cell.train_config["dataset"]["bucket_sampler_config"]
    traffic = Traffic(cell.traffic, cell.traffic_spec, sampler)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        noise = NoisePool(traffic, seed, device)
        first = [traffic.bucket_at(seed, i) for i in range(CHECKED_STEPS)]

        def batch_of(i):
            return make_batch(traffic, noise, seed, i, first[i], device)
        t0 = time.perf_counter()
        ref = readings(cell, seed, "reference", device, batch_of)
        ref_s = time.perf_counter() - t0
        for kind in args.kinds:
            t0 = time.perf_counter()
            got = readings(cell, seed, kind, device, batch_of)
            line = {"cell": cell.name, "seed": seed, "kind": kind,
                    **compare(got, ref), "losses": got.losses,
                    "reference_losses": ref.losses,
                    "buckets": first, "seconds": time.perf_counter() - t0,
                    "reference_seconds": ref_s,
                    "peak_bytes": torch.cuda.max_memory_allocated(device)}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
