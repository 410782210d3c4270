"""Run one cell of BENCHMARK.json once on the card:

    python3 -m s2t_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, breakdown (traced runs) and, last,
the checks with their limits, which also close standard error. Exits
non-zero, printing no result: 2 without a CUDA card or with fewer than
the cell asks for, 3 when a JAX module is loaded, 4 when a piece that
the cell names is not there (its workload, configuration file, traffic
mix, reference or counts module, check limits) or its reference refuses
its configuration, with one line on standard error that names it,
before any work on the card. Build and kernel caches stay in the
checkout's build/ directory.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .cell import ROOT, Missing, load_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch
    from .bench import JaxLoaded, run_cell
    try:
        cell = load_cell(args.workload)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"found {found}", file=sys.stderr)
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    except JaxLoaded:
        return 3
    except Missing as e:
        print(e, file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
