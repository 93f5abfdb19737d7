"""Measurement harness: time candidate plans on the real kernel backend.

One candidate = one :class:`~repro_torch.runtime.executable.Executable`
built with an explicitly chosen :class:`~repro_torch.gnn.executor.ModelPlan`
(instead of the analytic planner's pick) and timed on the full-graph
forward — the serving and training unit of work, the "forward time" of
``PERF.md`` §2. The protocol per candidate:

  * **warm-up** — untimed-for-score runs that pay the first forward's
    costs (the CSR index build, the kernel library's first launch); its
    wall time doubles as the timeout probe,
  * **median-of-k** — ``reps`` timed runs, each bracketed by
    ``torch.cuda.synchronize(device)`` on a card and timed by the host
    clock, scored by the median so one scheduler hiccup cannot crown
    the wrong winner,
  * **guards** — a candidate that raises (``torch.cuda.OutOfMemoryError``,
    a kernel's shape error, anything) or whose warm-up blows the
    per-candidate timeout is recorded with its failure and *skipped*;
    the search never crashes. A failure to build or load the kernel
    library (:class:`repro_torch.kernels._lib.LibraryError`) is no
    candidate's fault and propagates.

Graph tensors are pulled through the caller's
:class:`~repro_torch.runtime.cache.GraphStore` on ``device``, so
candidates that agree on ``shard_n`` share one sharded build (and the
winner's build is already resident when ``runtime.compile`` finishes).
The timing features are grouped per candidate and never stored there.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.gnn.executor import ModelPlan
from repro_torch.gnn.models import ZooSpec
from repro_torch.kernels import _lib
from repro_torch.kernels.registry import KernelBackend
from repro_torch.tune.search import layer_config, plan_digest


@dataclasses.dataclass
class Measurement:
    """One candidate's timing record (also what the winner store persists)."""

    digest: str                      # executed-config hash (search.plan_digest)
    config: list[dict]               # per-layer {B, n, S, order, fused}
    status: str                      # "ok" | "error" | "timeout"
    median_ms: float | None = None   # median of the timed reps
    reps_ms: tuple[float, ...] = ()
    warmup_ms: float | None = None   # first forward(s): index build + run
    error: str | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Measurement":
        d = dict(d)
        d["reps_ms"] = tuple(d.get("reps_ms", ()))
        return cls(**d)


def measure_plan(spec: ZooSpec, plan: ModelPlan, *, backend: KernelBackend,
                 edges: np.ndarray, num_nodes: int, features,
                 params: dict, store, graph_key, device: torch.device,
                 graph_version: int = 0, warmup: int = 1, reps: int = 3,
                 timeout_s: float | None = 30.0) -> Measurement:
    """Time one candidate plan on ``device``; raises only a
    :class:`~repro_torch.kernels._lib.LibraryError` (see module
    docstring)."""
    from repro_torch.runtime.executable import Executable

    on_card = device.type == "cuda"

    def run() -> None:
        exe.forward()
        if on_card:
            torch.cuda.synchronize(device)

    digest = plan_digest(plan)
    config = [layer_config(p) for p in plan.layers]
    try:
        # the entry is fetched featureless and the timing features are
        # grouped here: features the tuner synthesized for a featureless
        # graph must never become the caller's cached graph features
        entry = store.get(graph_key, edges, num_nodes, plan.shard_n,
                          spec.arch, device=device, version=graph_version)
        h = entry.gt.group(torch.as_tensor(features, dtype=torch.float32,
                                           device=device))
        exe = Executable(spec=spec, plan=plan, backend=backend, gt=entry.gt,
                         h_grouped=h, params=params, graph_key=graph_key)
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(max(warmup, 1)):
            run()
        warmup_ms = (time.perf_counter() - t0) * 1e3
        # the warm-up doubles as the timeout probe: a candidate whose
        # forward already blows the per-candidate budget is not worth reps
        if timeout_s is not None and warmup_ms > timeout_s * 1e3:
            return Measurement(digest=digest, config=config,
                               status="timeout", warmup_ms=warmup_ms,
                               error=f"warm-up {warmup_ms:.0f} ms exceeded "
                                     f"the {timeout_s:g} s candidate budget")
        reps_ms = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            run()
            reps_ms.append((time.perf_counter() - t0) * 1e3)
        return Measurement(digest=digest, config=config, status="ok",
                           median_ms=float(np.median(reps_ms)),
                           reps_ms=tuple(round(m, 4) for m in reps_ms),
                           warmup_ms=round(warmup_ms, 4))
    except _lib.LibraryError:
        raise
    except Exception as err:   # noqa: BLE001 — OOM, launch and shape
        # errors all land here; a failing candidate is a data point
        return Measurement(digest=digest, config=config, status="error",
                           error=f"{type(err).__name__}: {err}")
