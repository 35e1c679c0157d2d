"""The benchmark of the PyTorch and CUDA port, one cell once:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints, as its last line on standard output,
one JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` and, traced, ``breakdown``; ``compared`` comes last,
each number the check compared beside its limit, and the same numbers are
the last lines on standard error. Exits non-zero, with no result, without
enough CUDA cards for the cell, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, spec
    import torch

    chips = spec.Cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"{n} available", file=sys.stderr)
        return 2
    result, log = harness.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   torch.device("cuda"), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}, which the run must not import",
              file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
