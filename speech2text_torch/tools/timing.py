"""Kernel and wrapper timing on a CUDA card, at the main path's shapes.

`device_ms` is a kernel's own device time: the median duration of the
kernels whose name holds a given string in a `torch.profiler` trace.
`host_ms` is the host time of one call, the card synchronised before it.
`events_ms` puts CUDA events around each call (for the plain versions,
which are many kernels and their host work). `stack_shapes`,
`attn_inputs` and `pad_mask_of` give kernel B1 the shapes and inputs the
served model gives it.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Tuple

import torch

# traces `device_ms` takes of one call before it gives up on the tracer
TRACES = 3


def kernel_durations_ms(prof, name: str) -> List[float]:
    """Durations, ms, of the device kernels in the finished profile `prof`
    whose name contains `name`, in launch order."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and name in e.name]
    evs.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in evs]


def device_ms(call: Callable[[], object], name: str, iters: int = 30,
              warmup: int = 10) -> float:
    """Median device time, ms, of the kernel named `name` that `call`
    launches once: `iters` calls under torch.profiler after `warmup`
    calls. The tracer drops a kernel's record now and then (29 of 30
    records in some traces on the H100, 23 of 30 in one), so the median
    is taken over the records there are, and a trace with more than a
    tenth missing is taken again, up to TRACES times; raises if none
    holds enough, or if one holds more records than calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        durs = kernel_durations_ms(prof, name)
        if len(durs) > iters:
            break
        if len(durs) >= iters - iters // 10:
            return statistics.median(durs)
    raise RuntimeError(f"the trace of {iters} calls holds {len(durs)} "
                       f"kernels named {name!r}")


def host_ms(call: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """Median host time, ms, of one call: perf_counter around the call
    alone, the card synchronised before it."""
    for _ in range(warmup):
        call()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def events_ms(call: Callable[[], object], iters: int = 20,
              warmup: int = 3) -> float:
    """Median time, ms, between CUDA events recorded around each call."""
    for _ in range(warmup):
        call()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stack_shapes(cfg, n_samples: int) -> List[Tuple[int, int]]:
    """(T, H) of each encoder stack for an utterance of n_samples; `cfg`
    is the encoder's config dict."""
    from ..data.frontend import FbankConfig
    frames = FbankConfig().num_frames(n_samples)
    T0 = ((frames - 2 - 3) // 2 + 1) - 2
    return [(-(-T0 // ds), H) for ds, H in zip(cfg["downsampling_factor"],
                                               cfg["num_heads"])]


def attn_inputs(gen, B, T, H, qd, pd, dt):
    """Random q, k, qp, p on the card from the generator `gen`."""
    q, k = (torch.randn((B, T, H, qd), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    qp = torch.randn((B, T, H, pd), generator=gen, device="cuda").to(dt)
    p = torch.randn((2 * T - 1, H, pd), generator=gen, device="cuda").to(dt)
    return q, k, qp, p


def pad_mask_of(rng, B, T):
    """(B, T, T) pad mask on the card, lengths drawn from `rng`, the first
    utterance unpadded."""
    lens = torch.as_tensor(rng.integers(T // 5, T + 1, B))
    lens[0] = T
    pad = torch.arange(T)[None] < lens[:, None]
    return (pad[:, None, :] & pad[:, :, None]).cuda()
