"""The traced window: torch.profiler recording CUDA activity only (the
card's kernels, copies and sets, and the host's CUDA runtime calls), no
CPU operators, reduced to what the per-layer readers take.

Each device operation is tied to the runtime call that launched it by
the profiler's correlation id, and so to the program's spans whose host
interval holds that call, on any thread (autograd launches the
backward's kernels from its own thread while the main thread waits
inside the `backward` span). The spans come from the span clock
(spans.py), not from the profiler, and are moved onto the profiler's
clock by two markers: the window's first and last
torch.cuda.synchronize(), whose host times the window takes and whose
`cudaDeviceSynchronize` calls the trace holds; the two clocks drift
apart by about a millisecond over an 8 s window, so the offset is
interpolated between the markers. `busy_s` is the length of
the union of the device records; the idle gaps between them are named
by the innermost span open at their middle. The profiler drops a record
now and then, so counts of calls come from the port's launch counters,
not from here.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .spans import SPANS, Interval

TOP = 10
MARKER = "cudaDeviceSynchronize"


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Intervals:
    """Disjoint sorted intervals (ns) with a point lookup."""

    def __init__(self, iv: Iterable[Tuple[int, int]]):
        self.iv = _merge(list(iv))
        self.starts = [a for a, _ in self.iv]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.iv[i][1]

    def total_ns(self) -> int:
        return sum(b - a for a, b in self.iv)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    dur: int
    launch: Optional[int]      # host time of the launching call, ns


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    spans: Dict[str, Intervals]
    span_open: List[Tuple[int, int, str]]
    window: Tuple[int, int]
    unmatched: int

    @property
    def busy_s(self) -> float:
        return Intervals((o.start, o.start + o.dur)
                         for o in self.ops).total_ns() / 1e9

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside span `name`;
        None when the trace holds no such span."""
        iv = self.spans.get(name)
        if iv is None or not iv.iv:
            return None
        return sum(o.dur for o in self.ops
                   if o.launch is not None and iv.holds(o.launch)) / 1e9

    def kernel_device_s(self, names: Tuple[str, ...]) -> Optional[float]:
        """Device seconds of the kernels whose name holds any of `names`;
        None when there is none."""
        durs = [o.dur for o in self.ops if any(n in o.name for n in names)]
        return sum(durs) / 1e9 if durs else None

    def innermost(self, times: List[int]) -> List[str]:
        """For each of the ascending `times`, the innermost host span open
        there (the one opened last)."""
        out, active, k = [], [], 0
        for t in times:
            while k < len(self.span_open) and self.span_open[k][0] <= t:
                active.append(self.span_open[k])
                k += 1
            active = [s for s in active if s[1] > t]
            out.append(active[-1][2] if active
                       else "outside the program's spans")
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        by_op: Dict[str, int] = defaultdict(int)
        for o in self.ops:
            by_op[o.name] += o.dur
        busy = Intervals((o.start, o.start + o.dur) for o in self.ops).iv
        lo, hi = self.window
        edges = [(lo, lo)] + busy + [(hi, hi)]
        gaps = [(a, b) for (_, a), (b, _) in zip(edges[:-1], edges[1:])
                 if b > a]
        idle: Dict[str, int] = defaultdict(int)
        for (a, b), name in zip(gaps, self.innermost(
                [(a + b) // 2 for a, b in gaps])):
            idle[name] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in longest]}


def read_trace(prof, spans: Dict[str, List[Interval]],
               markers: Tuple[int, int]) -> Trace:
    """The Trace of a finished torch.profiler profile; `spans` are the
    span clock's intervals over the window and `markers` the host times
    (perf_counter ns) of its first and last synchronize."""
    cuda = torch.autograd.DeviceType.CUDA
    launches: Dict[int, int] = {}
    syncs: List[int] = []
    raw_ops = []
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        lo = start if lo is None else min(lo, start)
        hi = start + dur if hi is None else max(hi, start + dur)
        if e.device_type() == cuda:
            if name in SPANS:       # a span's device-side copy
                continue
            raw_ops.append((name, start, dur, e.correlation_id(),
                            e.linked_correlation_id()))
        elif name.startswith("cu"):     # CUDA runtime and driver calls
            launches[e.correlation_id()] = start
            if name == MARKER:
                syncs.append(start)
    ops, unmatched = [], 0
    for name, start, dur, corr, linked in raw_ops:
        t = launches.get(corr, launches.get(linked))
        unmatched += t is None
        ops.append(DeviceOp(name, start, dur, t))
    moved: Dict[str, List[Interval]] = {}
    if syncs:
        syncs.sort()
        first, last = syncs[0] - markers[0], syncs[-1] - markers[1]
        print(f"trace: span clock to profiler clock {first} ns at the "
              f"start, {last} ns at the end", file=sys.stderr)
        m0, span = markers[0], max(markers[1] - markers[0], 1)

        def shift(t: int) -> int:
            """The offset drifts between the markers: interpolated."""
            return t + first + (last - first) * (t - m0) // span
        moved = {n: [(shift(a), shift(b)) for a, b in iv]
                 for n, iv in spans.items()}
    span_open = sorted((a, b, n) for n, iv in moved.items() for a, b in iv)
    return Trace(ops, {n: Intervals(iv) for n, iv in moved.items()},
                 span_open, (lo or 0, hi or 0), unmatched)
