"""One run of one cell, from the checkout's root: the cell's driver (found
by its traffic's kind), its readings against the reference, the metrics the cell reports, and the result
line's fields. :mod:`perfbench.run` adds the look for a card and prints."""
from __future__ import annotations

import math
import subprocess
import sys

import torch

from perfbench import check, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.splitlines()[0] if out else "not read"


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> tuple[dict, list]:
    """-> (the result line's object, the lines for standard error)."""
    cell = spec.Cell(root, workload)
    run = cell.driver.run(cell, seed, seconds, trace, device, t0)
    run.chips = cell.chips
    values, _ = cell.driver.readings(run)
    correct, compared = check.judge(values, cell.limits)
    metrics = {}
    for m in cell.metrics(trace):
        v = spec.reader(root, m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    result = {"correct": correct and run.failed == 0,
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu",
                         "count": cell.chips,
                         "memory_peak_bytes": run.memory_peak_bytes,
                         "power_limit": power_limit()
                         if dev.type == "cuda" else "none"}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = compared
    log = [f"{workload} seed {seed}: setup_s {run.setup_s!r}, window "
           f"{run.window_s!r} s over {run.units} "
           f"{'steps' if run.kind == 'train' else 'batches'}, "
           f"{run.attempted} attempted, {run.failed} failed, peak "
           f"{run.memory_peak_bytes} B; {result['device']['kind']}, "
           f"{result['device']['power_limit']}"]
    log.append("set-up, seconds from the start at the end of each part: " +
               ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    if run.kind == "serve_batch":
        log.append("batch latencies (s): " + " ".join(
            f"{x:.4f}" for x in run.latencies_s[::run.mix["batch"]]))
    log += [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in compared.items()]
    return result, log
