"""The readings the limits in ``perfbench/limits/`` are set from, on the
card at the cell's own size, one process over many seeds:

    python3 perfbench/calibrate.py --workload <name> --seeds 101 102 ...

For each seed: a sound run of the program (set-up and the shortest window
that completes what a run compares) and its readings against the
reference; the control's (the reference in the program's place, its
products in float8 e4m3: the precision below the configuration's bf16);
and the further readings of the kind's driver (``faults``: for a training
cell the fault of half the batch left out, the mean taken over the rest,
planted in the reference put in the program's place).
Prints one JSON line a seed; not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings_for_seed(cell, seed: int, device) -> dict:
    run = cell.driver.run(cell, seed, 0.0, False, device,
                          time.perf_counter())
    program, ref = cell.driver.readings(run)
    out = {"seed": seed, "program": program,
           "control": cell.driver.control(run, ref)}
    out.update(cell.driver.faults(run, ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings_for_seed(cell, seed, torch.device("cuda"))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
