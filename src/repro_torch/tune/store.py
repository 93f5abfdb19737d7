"""Persistent winner store for autotuned plans (REPRO_PLAN_CACHE-backed).

A tuning run is expensive (budget × (warmup + reps) real forwards), so
winners are memoized twice, exactly like the analytic planner's memo:
in-process via a dict, across processes as JSON files
(``tune-<key>.json``) in the same ``REPRO_PLAN_CACHE`` directory the
analytic plan cache uses.

**Key scoping.** A measured winner is only meaningful in the environment
it was measured in. The key is :func:`repro_torch.gnn.executor.plan_key`
over the same (spec, graph size, platform, knobs) payload *plus* a scope
dict carrying (plan source, kernel backend name, device, torch version,
CUDA version, tuner version) and the search knobs (budget, seed, reps,
warmup). The device is ``"cpu"`` or the card's name: the ``cuda``
backend runs its plain versions on CPU tensors, so a key without the
device would serve a CPU-timed winner to a compile on the card. So a
winner timed on the CPU, or by the ``reference`` backend, never serves a
``cuda`` compile on the card, and bumping ``TUNER_VERSION`` invalidates
every stored winner at once.

**Corruption/staleness.** A record that fails to parse, fails schema
validation, or carries a different ``TUNER_VERSION`` is treated as a
cache miss (counted in ``tune_cache_stats()["corrupt"]``), never an
error: the caller falls back to re-tuning or the analytic plan.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import torch

from repro_torch import env
from repro_torch.core.perf_model import Platform
from repro_torch.gnn.executor import ModelPlan, plan_key
from repro_torch.gnn.models import ZooSpec
from repro_torch.tune.measure import Measurement
from repro_torch.tune.search import layer_config

# the reference's version (its v2: static plan pruning changed the
# measured candidate set); bumping invalidates every stored record at
# once (stale versions load as cache misses). Records never cross
# packages: the scope's keys differ.
TUNER_VERSION = 2

_TUNE_CACHE: dict[str, "TuneRecord"] = {}
_TUNE_STATS = {"hits": 0, "misses": 0, "disk_hits": 0, "corrupt": 0,
               "measurements": 0}


def tune_cache_stats() -> dict:
    return dict(_TUNE_STATS)


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()
    for k in _TUNE_STATS:
        _TUNE_STATS[k] = 0


def count_measurements(n: int) -> None:
    _TUNE_STATS["measurements"] += n


def tune_scope(backend_name: str, device: torch.device | str) -> dict:
    """The environment half of the winner key (see module docstring)."""
    d = env.describe(device)
    return {
        "plan_source": "autotune",
        "backend": backend_name,
        "device": d["device"],
        "torch_version": d["torch_version"],
        "cuda_version": d["cuda_version"],
        "tuner_version": TUNER_VERSION,
    }


def tune_key(spec: ZooSpec, num_nodes: int, num_edges: int, *,
             platform: Platform, max_n: int,
             block_candidates: tuple[int, ...], backend_name: str,
             device: torch.device | str,
             budget: int, seed: int, reps: int, warmup: int) -> str:
    scope = {**tune_scope(backend_name, device),
             "budget": budget, "seed": seed, "reps": reps, "warmup": warmup}
    return plan_key(spec, num_nodes, num_edges, platform=platform,
                    max_n=max_n, block_candidates=block_candidates,
                    scope=scope)


@dataclasses.dataclass
class TuneRecord:
    """The memoized outcome of one tuning run."""

    plan: ModelPlan                  # the winner (analytic on fallback)
    plan_source: str                 # "autotune" | "analytic_fallback"
    winner_ms: float | None          # winner's median forward
    analytic_ms: float | None        # analytic plan's median forward
    speedup: float | None            # analytic_ms / winner_ms
    candidates: tuple[Measurement, ...]
    scope: dict                      # environment the timings are valid in
    # candidates rejected by static analysis before any measurement
    # (repro_torch.analyze.plan_lint.prune_candidates records), never
    # silently dropped from the report
    pruned: tuple[dict, ...] = ()

    @property
    def n_measured(self) -> int:
        return len(self.candidates)

    def report(self) -> dict:
        """What Executable.summary() and chip_smoke.py surface."""
        errors = sum(1 for m in self.candidates if m.status != "ok")
        by_reason: dict[str, int] = {}
        for p in self.pruned:
            r = p.get("reason", "unknown")
            by_reason[r] = by_reason.get(r, 0) + 1
        return {"plan_source": self.plan_source,
                "winner_ms": self.winner_ms,
                "analytic_ms": self.analytic_ms,
                "speedup": self.speedup,
                "candidates_measured": self.n_measured,
                "candidates_failed": errors,
                "candidates_pruned": len(self.pruned),
                "pruned_reasons": by_reason,
                "winner_config": [layer_config(p) for p in self.plan.layers]}

    def to_json(self) -> dict:
        return {"tuner_version": self.scope.get("tuner_version"),
                "plan": self.plan.to_json(),
                "plan_source": self.plan_source,
                "winner_ms": self.winner_ms,
                "analytic_ms": self.analytic_ms,
                "speedup": self.speedup,
                "candidates": [m.to_json() for m in self.candidates],
                "pruned": [dict(p) for p in self.pruned],
                "scope": self.scope}

    @classmethod
    def from_json(cls, d: dict) -> "TuneRecord":
        if d.get("tuner_version") != TUNER_VERSION:
            raise ValueError(f"stale tuner_version {d.get('tuner_version')}")
        if d.get("plan_source") not in ("autotune", "analytic_fallback"):
            raise ValueError(f"bad plan_source {d.get('plan_source')!r}")
        return cls(plan=ModelPlan.from_json(d["plan"]),
                   plan_source=d["plan_source"],
                   winner_ms=d.get("winner_ms"),
                   analytic_ms=d.get("analytic_ms"),
                   speedup=d.get("speedup"),
                   candidates=tuple(Measurement.from_json(m)
                                    for m in d.get("candidates", ())),
                   pruned=tuple(dict(p) for p in d.get("pruned", ())),
                   scope=dict(d.get("scope", {})))


def _disk_path(key: str, cache_dir) -> pathlib.Path | None:
    if cache_dir is None:
        cache_dir = os.environ.get("REPRO_PLAN_CACHE") or None
    if cache_dir is None:
        return None
    return pathlib.Path(cache_dir) / f"tune-{key}.json"


def load_record(key: str, cache_dir=None) -> TuneRecord | None:
    """Memo lookup: in-process dict, then disk. Corrupt/stale disk entries
    count as misses (and are left in place for post-mortems)."""
    rec = _TUNE_CACHE.get(key)
    if rec is not None:
        _TUNE_STATS["hits"] += 1
        return rec
    disk = _disk_path(key, cache_dir)
    if disk is not None and disk.exists():
        try:
            rec = TuneRecord.from_json(json.loads(disk.read_text()))
        except Exception:   # noqa: BLE001 — any parse/schema/version
            # failure degrades to a miss; tuning (or the analytic plan)
            # takes over instead of an unserveable model
            _TUNE_STATS["corrupt"] += 1
        else:
            _TUNE_STATS["disk_hits"] += 1
            _TUNE_CACHE[key] = rec
            return rec
    _TUNE_STATS["misses"] += 1
    return None


def save_record(key: str, rec: TuneRecord, cache_dir=None) -> None:
    _TUNE_CACHE[key] = rec
    disk = _disk_path(key, cache_dir)
    if disk is not None:
        disk.parent.mkdir(parents=True, exist_ok=True)
        disk.write_text(json.dumps(rec.to_json()) + "\n")
