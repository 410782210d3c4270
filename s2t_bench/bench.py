"""One run of one cell: set-up, the measured window, the per-layer
readings, and the check that decides `correct`.

Before set-up, and before any work on the card, the run finds what the
cell's configuration file names (cell.py): its reference module, which
has to take the configuration (`check_config`), its counts module, and
the check limits `checks/<cell>.json`; a piece that is not there raises
cell.Missing.

Set-up (counted in setup_s from the process's start): torch and the
port imported, kernels built or loaded, the task, Trainer, weights and
optimizer made, the noise clips made on the device, then the checked
steps (check.py) and one step of every bucket shape they did not cover,
all through `Trainer.train_step` on the window's own feed: so nothing
compiles or warms up inside the window. The window then takes steps of
the seed's schedule until `seconds` have passed, and waits for the card:
the rate is the unpadded audio of every step it took over its whole
length. The window starts at a block of the schedule (workload.BLOCK
steps, the same shapes for every seed) and ends with one, the first
block end after `seconds`, so every seed's window does the same work.

A traced run takes the same window untraced first, and reads from it
what the host clock gives (the model FLOP rate, the peak memory, the
spans' host time by the span clock, spans.py); then a second window,
cut to TRACE_SECONDS, under torch.profiler recording CUDA activity only,
for what the card's records give (busy and idle time, each span's device
time, the kernels' rooflines). Standard error gives the traced window's
time per step against the untraced one's: what the tracer costs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import math
import resource
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .cell import PACKAGE, Cell
from .check import (CHECKED_STEPS, NUMBERS, checked_steps, compare,
                    limits_of, verdict)
from .guard import jax_modules
from .program import Program
from .spans import Interval, SpanClock
from .trace import Trace, read_trace
from .weights import write_weights
from .workload import BLOCK, NoisePool, Traffic, make_batch

METRICS_DIR = PACKAGE / "metrics"
# the traced window's least length: its per-layer readings are per step,
# and a traced run also takes the untraced window within its time limit
TRACE_SECONDS = 16.0


class JaxLoaded(RuntimeError):
    pass


@dataclasses.dataclass
class StepInfo:
    bucket: int
    batch: int
    pcm_len: int
    label_len: int
    noise_len: int
    audio_s: float


@dataclasses.dataclass
class Window:
    """One window: its steps and length, the span clock's intervals over
    it, the port's launch counters over it, its peak memory, and its
    trace where it was traced."""
    steps: List[StepInfo]
    seconds: float
    spans: Dict[str, List[Interval]]
    launches: Dict[str, int]
    peak_mem_bytes: int
    trace: Optional[Trace] = None
    markers: Tuple[int, int] = (0, 0)


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the untraced window (`timed`) and
    the traced one (`traced`) of one run."""
    cell: Cell
    timed: Window
    traced: Optional[Window]
    float32_matmul_precision: str


def reader(name: str):
    """The reader of per-layer metric `name`: metrics/<name>.py's `read`."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"s2t_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _guard(when: str) -> None:
    found = jax_modules()
    if found:
        print(f"JAX modules loaded {when}: {', '.join(found)}",
              file=sys.stderr)
        raise JaxLoaded(", ".join(found))


class HostWatch:
    """What the host did over a window, for standard error: time in
    Python's garbage collector, the process's involuntary context
    switches and CPU time, and the CUDA allocator's retries (each one
    frees cached blocks and waits for the card)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.gc_s = 0.0
        self.gc_runs = [0, 0, 0]
        self._t = 0.0

    def _gc(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs[info["generation"]] += 1

    def _retries(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_stats(self.device).get(
            "num_alloc_retries", 0)

    def __enter__(self) -> "HostWatch":
        gc.callbacks.append(self._gc)
        self._r0 = resource.getrusage(resource.RUSAGE_SELF)
        self._a0 = self._retries()
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._gc)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        print(f"host: gc {self.gc_s:.3f} s in {self.gc_runs} collections; "
              f"involuntary switches {r1.ru_nivcsw - self._r0.ru_nivcsw}; "
              f"cpu user {r1.ru_utime - self._r0.ru_utime:.2f} s system "
              f"{r1.ru_stime - self._r0.ru_stime:.2f} s; allocator retries "
              f"{self._retries() - self._a0}", file=sys.stderr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def card(device: torch.device) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def set_precision(meta: Dict[str, Any]) -> None:
    """float32 products as the configuration states ("highest": TF32 off
    in matmuls and cuDNN)."""
    prec = meta.get("float32_matmul_precision", "highest")
    torch.set_float32_matmul_precision(prec)
    torch.backends.cudnn.allow_tf32 = prec != "highest"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> Dict[str, Any]:
    reference = cell.reference()
    cell.part("counts")
    limits = limits_of(cell.name)
    set_precision(cell.meta)
    SpanClock.install()
    cfg = cell.train_config
    sampler = cfg["dataset"]["bucket_sampler_config"]
    traffic = Traffic(cell.traffic, cell.traffic_spec, sampler)
    noise = NoisePool(traffic, seed, device)
    first = [traffic.bucket_at(seed, i) for i in range(CHECKED_STEPS)]
    rest = [b for b in range(len(traffic.buckets)) if b not in first]

    def batch_of(step: int, bucket: int):
        with record_function("bench_batch"):
            return make_batch(traffic, noise, seed, step, bucket, device)

    losses: List[torch.Tensor] = []
    step, position = CHECKED_STEPS, BLOCK

    def window(program: Program, length: float) -> Window:
        """Steps from the next block until `length` seconds have passed
        and a block has ended, the card waited for at both ends."""
        nonlocal step, position
        steps: List[StepInfo] = []
        before = program.launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        SpanClock.take()
        mark0 = time.perf_counter_ns()
        _sync(device)
        with HostWatch(device):
            t0 = time.perf_counter()
            ends: List[float] = []
            while True:
                b = traffic.bucket_at(seed, position)
                batch = batch_of(step, b)
                rows = traffic.rows(seed, step, b)
                out = program.train_step(batch, step)
                ends.append(time.perf_counter())
                losses.append(out["train_loss"])
                s = traffic.buckets[b]
                steps.append(StepInfo(b, s.batch_size, s.pcm_len,
                                      s.label_len, int(noise.pcm.shape[1]),
                                      traffic.audio_seconds(rows)))
                step += 1
                position += 1
                if position % BLOCK == 0 and \
                        time.perf_counter() - t0 >= length:
                    break
            mark1 = time.perf_counter_ns()
            _sync(device)
            took = time.perf_counter() - t0
        after = program.launches()
        gaps = np.diff([t0] + ends)
        print(f"window: {len(steps)} steps in {took:.3f} s; host s per "
              f"step launched p10/p50/p90/max " + " / ".join(
                  f"{q:.3f}" for q in np.percentile(gaps, (10, 50, 90, 100))),
              file=sys.stderr)
        return Window(steps, took, SpanClock.take(),
                      {k: after[k] - before[k] for k in after},
                      _peak(device), markers=(mark0, mark1))

    marks = [("imports", time.perf_counter())]
    with tempfile.TemporaryDirectory(prefix="s2t_bench_") as workdir:
        program = Program(cfg, seed, device, workdir)
        marks.append(("program", time.perf_counter()))
        got = checked_steps(program.model, program.train_step,
                            lambda i: batch_of(i, first[i]), "train_loss")
        marks.append(("checked steps", time.perf_counter()))
        for b in rest:
            program.train_step(batch_of(step, b), step)
            step += 1
        _sync(device)
        marks.append(("other shapes", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print("set-up: " + ", ".join(
            f"{n} {t - p:.1f} s" for (n, t), (_, p) in
            zip(marks, [("start", t_start)] + marks[:-1])), file=sys.stderr)
        _guard("after set-up")
        peak_setup = _peak(device)
        timed = window(program, seconds)
        traced = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[
                ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU])
            with prof:
                traced = window(program, min(seconds, TRACE_SECONDS))
            traced.trace = read_trace(prof, traced.spans, traced.markers)
            del prof
            per = [w.seconds / len(w.steps) for w in (timed, traced)]
            print(f"traced window: {per[1]:.4f} s per step, "
                  f"{per[1] / per[0]:.4f} x the untraced window's "
                  f"{per[0]:.4f}; {len(traced.trace.ops)} device records, "
                  f"{traced.trace.unmatched} not tied to a launch",
                  file=sys.stderr)
        failed = sum(not math.isfinite(float(x)) for x in losses)
        program.close()
        del program, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    dev = card(device)
    dev["memory_peak_bytes"] = max(peak_setup, timed.peak_mem_bytes,
                                   traced.peak_mem_bytes if traced else 0)
    result: Dict[str, Any] = {"correct": False,
                              "attempted": len(timed.steps)
                              + (len(traced.steps) if traced else 0),
                              "failed": failed, "metrics": {}}
    names = [m["name"] for m in cell.metrics(trace)]
    units = {m["name"]: m["unit"] for m in cell.metrics(trace)}
    if not trace:
        audio = sum(s.audio_s for s in timed.steps)
        values = {"train_audio_s_per_s": audio / timed.seconds,
                  "setup_s": setup_s}
    else:
        r = Readings(cell, timed, traced,
                     torch.get_float32_matmul_precision())
        values = {n: reader(n)(r) for n in names}
        dev["busy_s"] = traced.trace.busy_s
        dev["window_s"] = traced.seconds
        result["breakdown"] = traced.trace.breakdown()
    for n in names:
        v = values.get(n)
        if v is not None:
            result["metrics"][n] = {"value": v, "unit": units[n]}
    result["device"] = dev

    t_ref = time.perf_counter()
    ref = reference.ReferenceTrainer(cfg, seed, device,
                                     lambda m: write_weights(m, seed))
    want = checked_steps(ref.model, ref.train_step,
                         lambda i: batch_of(i, first[i]), "loss")
    del ref
    _sync(device)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    numbers = compare(got, want)
    result["correct"] = verdict(numbers, limits) and failed == 0
    print(f"losses program {got.losses} reference {want.losses}",
          file=sys.stderr)
    for k in NUMBERS:
        print(f"{k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in NUMBERS}
    _guard("after the window")
    return result
