"""The program's `record_function` spans on the host clock, without a
profiler: a hook on record_function's enter and exit takes
time.perf_counter_ns() for the spans named in SPANS (the program's
featurize, encoder, joiner_losses, backward, optimizer, and the
harness's own bench_batch). It costs two clock reads per span, so the
window it times runs as an untraced window does; the profiler's own CPU
tracing slows the flagship's host-paced loops about twofold.

`SpanClock.install()` hooks record_function once per process;
`take()` hands over and clears what was recorded since the last take.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd.profiler import record_function

SPANS = ("featurize", "encoder", "joiner_losses", "backward", "optimizer",
         "bench_batch")

Interval = Tuple[int, int]


def merged_s(iv: List[Interval]) -> float:
    """Seconds covered by the intervals (ns), overlaps counted once."""
    total, end = 0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


class SpanClock:
    _records: List[Tuple[str, int, int]] = []
    _installed = False

    @classmethod
    def install(cls) -> None:
        if cls._installed:
            return
        enter, leave = record_function.__enter__, record_function.__exit__
        records = cls._records

        def timed_enter(rf):
            out = enter(rf)
            if rf.name in SPANS:
                rf._bench_t0 = time.perf_counter_ns()
            return out

        def timed_exit(rf, *exc):
            t0 = getattr(rf, "_bench_t0", None)
            if t0 is not None:
                records.append((rf.name, t0, time.perf_counter_ns()))
            return leave(rf, *exc)

        record_function.__enter__ = timed_enter
        record_function.__exit__ = timed_exit
        cls._installed = True

    @classmethod
    def take(cls) -> Dict[str, List[Interval]]:
        """The spans closed since the last take, by name (ns, host)."""
        out: Dict[str, List[Interval]] = defaultdict(list)
        for name, a, b in cls._records:
            out[name].append((a, b))
        cls._records.clear()
        return dict(out)
