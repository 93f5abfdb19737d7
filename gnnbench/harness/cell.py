"""One run of one cell: drive the program, check its answers, read the
metrics, and form the result line."""
from __future__ import annotations

import math
import sys

import numpy as np

from gnnbench.harness import peaks as peaks_mod
from gnnbench.harness import spec
from gnnbench.harness.check import Checker, verdict
from gnnbench.harness.drive import Driver

# top-level module names that may not be loaded in a run's process: JAX,
# its libraries, the JAX package this program is a port of, and its
# benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def breakdown(run) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each named by what the driver was doing over most of it."""
    tr = run.trace
    ops = [[name[:120], secs] for name, secs in tr.time_by_name()[:10]]
    gaps = tr.gaps()
    longest = gaps[(gaps[:, 0] - gaps[:, 1]).argsort()[:10]]
    return {"device_ops": ops,
            "idle_gaps": [[host_activity(run, a, b), float(b - a)]
                          for a, b in longest]}


def _covered(starts, ends, a: float, b: float) -> float:
    """Seconds of [a, b] inside the union of the spans [start, end]."""
    s = np.clip(np.asarray(starts, dtype=float), a, b)
    e = np.clip(np.asarray(ends, dtype=float), a, b)
    keep = e > s            # drops spans outside [a, b] and unfinished ones
    total, reach = 0.0, a
    for lo, hi in sorted(zip(s[keep], e[keep])):
        lo = max(lo, reach)
        if hi > lo:
            total += hi - lo
            reach = hi
    return total


def host_activity(run, a: float, b: float) -> str:
    """What the driver's spans covered most of [a, b] (the first named
    on a tie): weight pushes, refresh requests (submitted, not yet seen
    answered), or neither."""
    spans = {
        "engine: Server.reload": ([r.t_reload for r in run.refreshes],
                                  [r.t_submit for r in run.refreshes]),
        "server: refresh request, host side": (
            [r.t_submit for r in run.refreshes],
            [r.t_done for r in run.refreshes]),
    }
    cover = {name: _covered(s, e, a, b) for name, (s, e) in spans.items()}
    name = max(cover, key=cover.get)
    return name if cover[name] > 0 else "driver: no work due"


def run_cell(root, workload: str, *, seed: int, seconds: float,
             trace: bool, device: str, t_process: float,
             control: bool = False,
             base=spec.HERE) -> tuple[dict, dict, object]:
    """(result, numbers, run): the result line's object, the compared
    numbers (with the control's, when asked) and the driver's records."""
    cell = spec.resolve(root, workload, base)
    driver = Driver(cell, seed, seconds, device, trace, t_process)
    run = driver.run()
    run.peaks = peaks_mod.for_device(run.device_kind)
    checker = Checker(cell.reference, driver.graph, driver.weights, device,
                      control=control)
    numbers = checker.check(run)
    correct, table = verdict(numbers, cell.limits)
    kind = "end_to_end" if not trace else "per_layer"
    metrics = {}
    for m in cell.metrics_of(kind):
        value = m.reader.read(run)
        if value is not None and math.isfinite(value):
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    attempted, failed = counts(run)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "cpu" if device == "cpu" else "gpu",
                         "kind": run.device_kind, "count": cell.chips,
                         "memory_peak_bytes": run.memory_peak_bytes}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run)
    result["checks"] = table
    return result, numbers, run


def counts(run) -> tuple[int, int]:
    """(attempted, failed): the window's refreshes; one rejected,
    expired, failed or never answered counts as failed."""
    failed = sum(r.outcome != "completed" for r in run.refreshes)
    return len(run.refreshes), failed
