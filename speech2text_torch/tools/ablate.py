"""Ablations of the port's CUDA kernels: what holds each one back.

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m speech2text_torch.tools.ablate [--out FILE]

Each variant is a kernel's source with one step taken out by a text
substitution guarded by a condition the compiler cannot decide (so the
rest of the code stays as it is); its output is wrong and only its time
is read. All variants are built at once with nvcc into build/kernels/,
launched through the kernel's own wrapper at the main path's shapes
(B=16, 10 s: kernel B1 at each encoder stack shape with a pad mask,
kernel B2 once) and timed by device time (`timing.device_ms`) in two
rounds: the variants in order, then in reverse. The times go to stdout
and, as JSON, to FILE (default build/ablate/ablate.json). A substitution
that no longer matches its source raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import attn_weights as aw
from ..ops import build
from ..ops import fbank as fb
from .timing import attn_inputs, device_ms, pad_mask_of, stack_shapes

SR = 16000
B = 16
SEED = 0
CFG = "configs/inference/pruned_rnnt_greedy_search.yaml"

Subst = List[Tuple[str, str]]
# kernel B1 (csrc/attn_weights.cu, bf16 tensor-core kernel)
ATTN_VARIANTS: Dict[str, Subst] = {
    "base": [],
    # no global stores of the weights (the staging tile is still written)
    "nostore": [("        if (tw + i < T) {",
                 "        if (tw + i < T && T < 0) {")],
    # no relative-position term (no table reads, no 4 FMAs per score)
    "nopos": [("          float v = acc[2 * hi + e] * inv_qd + pos * inv_pd;",
               "          float v = acc[2 * hi + e] * inv_qd;")],
    # pass 1 sums (s - m) instead of exp(s - m)
    "noexp1": [("            l[hi] += expf(sc[j][2 * hi] - m[hi]) + "
                "expf(sc[j][2 * hi + 1] - m[hi]);",
                "            l[hi] += (sc[j][2 * hi] - m[hi]) + "
                "(sc[j][2 * hi + 1] - m[hi]);")],
    # pass 2 writes (s - m) / l instead of exp(s - m) / l
    "noexp2": [("          const float w0 = expf(sc[j][2 * hi] - m[hi]) * l[hi];",
                "          const float w0 = (sc[j][2 * hi] - m[hi]) * l[hi];"),
               ("          const float w1 = expf(sc[j][2 * hi + 1] - m[hi]) * l[hi];",
                "          const float w1 = (sc[j][2 * hi + 1] - m[hi]) * l[hi];")],
    # pass 2 alone: what a one-pass design that kept the scores would pay
    # at least
    "pass2only": [("  for (int it = 0, buf = 0; it < 2 * nch;",
                   "  for (int it = nch, buf = 0; it < 2 * nch;")],
}
# kernel B2 (csrc/fbank.cu)
FBANK_VARIANTS: Dict[str, Subst] = {
    "base": [],
    # no PCM read from global memory (the span is zero-filled)
    "noload": [("    span[i] = x[frame_index(first + i, N, snip)];",
                "    span[i] = N < 0 ? x[frame_index(first + i, N, snip)] "
                ": 0.f;")],
    # no radix-4 FFT stages (the packed frame goes straight to the split
    # at 512 points, which has no radix-2 stage)
    "nofft": [("    for (int st = 0; st < R4_STAGES; ++st) {",
               "    for (int st = 0; st < (N < 0 ? R4_STAGES : 0); ++st) {")],
    # no mel sums (every filter's sum is 0)
    "nomel": [("      for (int j = 0; j < len; ++j)",
               "      for (int j = 0; j < (N < 0 ? len : 0); ++j)")],
    # no feature stores (the log is still taken)
    "nostore": [("      orow[m] = logf(fmaxf(acc, eps));",
                 "      const float v = logf(fmaxf(acc, eps));\n"
                 "      if (__float_as_int(v) == -N) orow[m] = v;")],
}


def variant_kernels(kernel: build.CudaKernel, variants: Dict[str, Subst],
                    out_dir: Path) -> Dict[str, build.CudaKernel]:
    """One CudaKernel per variant, its source written under `out_dir`."""
    src = kernel.source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, subst in variants.items():
        text = src
        for old, new in subst:
            if text.count(old) != 1:
                raise ValueError(f"{kernel.name} {name}: {old!r} occurs "
                                 f"{text.count(old)} times in the source")
            text = text.replace(old, new)
        path = out_dir / f"{kernel.name}_{name}.cu"
        path.write_text(text)
        kernels[name] = build.CudaKernel(f"{kernel.name}_{name}", str(path),
                                         entries=kernel.entries)
    return kernels


@contextlib.contextmanager
def swapped(module, kernel: build.CudaKernel):
    """The wrapper module `module` launches `kernel` inside the block."""
    saved = module.KERNEL
    module.KERNEL = kernel
    try:
        yield
    finally:
        module.KERNEL = saved


def in_rounds(module, kernels: Dict[str, build.CudaKernel], call,
              name: str) -> Dict[str, List[float]]:
    """Device ms of `call` with each variant, in order and then reversed."""
    times: Dict[str, List[float]] = {v: [] for v in kernels}
    order = list(kernels)
    for v in order + order[::-1]:
        with swapped(module, kernels[v]):
            times[v].append(device_ms(call, name))
    return times


def ablate_attn(kernels, report) -> None:
    from ..config import load_config
    from ..serve import serving_train_config
    cfg = serving_train_config(load_config(CFG))["encoder"]["config"]
    qd, pd = cfg["query_head_dim"], cfg["pos_head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    dt = torch.bfloat16
    for T, H in sorted(set(stack_shapes(cfg, 10 * SR))):
        q, k, qp, p = attn_inputs(gen, B, T, H, qd, pd, dt)
        mask = pad_mask_of(rng, B, T)
        times = in_rounds(aw, kernels, lambda: aw.attn_weights_cuda(
            q, k, qp, p, mask, dt), aw.KERNEL.name)
        for v, t in times.items():
            report[f"attn_weights T={T} H={H} {v}"] = t
            print(f"attn_weights B={B} T={T} H={H} pad mask {v:10s} "
                  f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)


def ablate_fbank(kernels, report) -> None:
    from ..data.frontend import Fbank
    rng = np.random.default_rng(SEED + 1)
    N = 10 * SR + 77
    fbank = Fbank().cuda()
    cfg = fbank.cfg
    x = torch.from_numpy((0.2 * rng.standard_normal((B, N)))
                         .astype(np.float32)).cuda()
    T = cfg.num_frames(N)
    ops = (fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks)
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
              preemph=cfg.preemphasis, remove_dc=cfg.remove_dc_offset)
    times = in_rounds(fb, kernels, lambda: fb.fbank_cuda(x, *ops, T, **kw),
                      fb.KERNEL.name)
    for v, t in times.items():
        report[f"fbank B={B} frames={T} {v}"] = t
        print(f"fbank B={B} frames={T} {v:10s} {t[0]:.4f} / {t[1]:.4f} ms",
              flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(build.BUILD_DIR.parent / "ablate"
                                         / "ablate.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src_dir = build.BUILD_DIR.parent / "ablate"
    attn = variant_kernels(aw.KERNEL, ATTN_VARIANTS, src_dir)
    fbank = variant_kernels(fb.KERNEL, FBANK_VARIANTS, src_dir)
    build.build([*attn.values(), *fbank.values()])
    report: Dict[str, object] = {"card": card}
    ablate_attn(attn, report)
    ablate_fbank(fbank, report)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
