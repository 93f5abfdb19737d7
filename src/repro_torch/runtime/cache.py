"""Signature-keyed GraphTensors store (GNNIE-style graph-specific caching).

The expensive compile-time artifact is the sharded, normalization-baked
:class:`~repro_torch.core.engines.GraphTensors` (+ shard-grouped
features) on the device. One entry is keyed on ``(graph_key, version,
normalize, self_loops, shard_n, device)`` — the signature
:func:`repro_torch.gnn.models.graph_signature` assigns each architecture,
plus the graph's **monotonic version**: a streaming delta bumps the
version, so a stale build can never be returned for a post-delta request
(the key no longer exists). Models with the same signature share one
build. Entries are LRU-evicted at a configurable capacity.

Mutable entries (``get(..., mutable=True)``) are built through
:class:`repro_torch.graphs.patch.PatchState` with slack-slot edge
capacity; :meth:`GraphStore.patch` then advances them — incremental
shard rewrite of the host mirror, a copy-on-write device update and a
re-key to the new version — instead of a from-scratch rebuild.

Compiles (:func:`repro_torch.runtime.compile` calls) and graph builds
(misses of any store) are counted (:func:`compile_counts`), as the
kernel library counts its launches: they are the first-use work a
request pays, and the build-stability pass
(:mod:`repro_torch.analyze.op_lint`) holds a warm path to none.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.analyze.lock_sanitizer import new_rlock
from repro_torch.core.engines import GraphTensors
from repro_torch.gnn.models import graph_signature
from repro_torch.graphs.delta import apply_to_edge_list
from repro_torch.graphs.patch import PatchState


_count_lock = threading.Lock()
_counts = {"compiles": 0, "graph_builds": 0}


def count(kind: str) -> None:
    """Add one to the ``compiles`` or ``graph_builds`` counter."""
    with _count_lock:
        _counts[kind] += 1


def compile_counts() -> dict[str, int]:
    """Compiles and graph builds counted since the process started."""
    with _count_lock:
        return dict(_counts)


@dataclasses.dataclass
class GraphEntry:
    gt: GraphTensors
    h_grouped: torch.Tensor | None   # (S, n, F) shard-grouped features
    built_ms: float
    version: int = 0
    # numpy master copy for incremental patching; None = immutable build
    patch_state: object | None = None


def _group(gt: GraphTensors, features: np.ndarray) -> torch.Tensor:
    # outside inference mode: a trainer may save it for a backward
    with torch.inference_mode(False):
        return gt.group(torch.as_tensor(features, dtype=torch.float32,
                                        device=gt.device))


class GraphStore:
    """LRU cache of sharded graph builds, keyed by normalization signature."""

    def __init__(self, max_entries: int = 8):
        # shared by the serving engine's step and mutate paths, direct
        # compiles and the stream trainer: one reentrant lock makes
        # fetch-or-build and a whole patch atomic
        self._lock = new_rlock("GraphStore._lock")
        self._entries: OrderedDict[tuple, GraphEntry] = OrderedDict()  # guarded-by: _lock
        self.max_entries = max_entries
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,  # guarded-by: _lock
                      "built_ms_total": 0.0, "patches": 0,
                      "patch_rebuilds": 0, "patch_drops": 0,
                      "patch_ms_total": 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, graph_key, edges: np.ndarray, num_nodes: int,
            shard_n: int, arch: str, features: np.ndarray | None = None,
            *, device: torch.device, version: int = 0,
            mutable: bool = False, edge_slack: float = 0.25) -> GraphEntry:
        """Fetch-or-build the GraphTensors for ``arch``'s signature on
        ``device`` at graph ``version``. Features are grouped once and
        cached alongside; an entry built featureless gains them on the
        first featureful get. ``mutable=True`` builds through a
        PatchState with ``edge_slack`` slack capacity so later
        :meth:`patch` calls stay in-template; a mutable request on an
        immutable entry rebuilds it."""
        from repro_torch.runtime.forward import build_graph_tensors

        norm, loops = graph_signature(arch)
        key = (graph_key, version, norm, loops, shard_n, str(device))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and \
                    not (mutable and entry.patch_state is None):
                self.stats["hits"] += 1
                self._entries.move_to_end(key)
            else:
                self.stats["misses"] += 1
                count("graph_builds")
                t0 = time.perf_counter()
                if mutable:
                    ps = PatchState(edges, num_nodes, shard_n,
                                    normalize=norm, add_self_loops=loops,
                                    slack=edge_slack)
                    gt = ps.to_graph_tensors(device=device)
                else:
                    ps = None
                    gt = build_graph_tensors(edges, num_nodes, shard_n,
                                             arch, device)
                entry = GraphEntry(gt=gt, h_grouped=None,
                                   built_ms=(time.perf_counter() - t0) * 1e3,
                                   version=version, patch_state=ps)
                self.stats["built_ms_total"] += entry.built_ms
                self._entries[key] = entry
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.stats["evictions"] += 1
            if entry.h_grouped is None and features is not None:
                entry.h_grouped = _group(entry.gt, features)
            return entry

    def patch(self, graph_key, delta, *, old_version: int,
              new_version: int, features: np.ndarray | None = None) -> dict:
        """Advance every ``(graph_key, old_version)`` entry through one
        :class:`~repro_torch.graphs.delta.GraphDelta` and re-key it to
        ``new_version``.

        Mutable entries are patched incrementally (a copy-on-write update
        of the affected shard pairs while the template holds, a full
        upload after a compaction); immutable entries are DROPPED — their
        consumers rebuild on the next versioned ``get``. ``features``
        (the post-delta (N, F) matrix) regroups the shard-grouped
        features on the device; pass it when the delta added nodes.
        Returns ``{(norm, loops, shard_n, device): (entry,
        PatchResult)}`` for the survivors. The delta is validated against
        the canonical edge list before any entry is touched, so a raising
        delta leaves the store consistent.
        """
        with self._lock:
            keys = [k for k in self._entries
                    if k[0] == graph_key and k[1] == old_version]
            mutable_keys = [k for k in keys
                            if self._entries[k].patch_state is not None]
            if mutable_keys:
                ps0 = self._entries[mutable_keys[0]].patch_state
                # pure validation pass (raises without mutating anything)
                apply_to_edge_list(ps0.edges, ps0.num_nodes, delta)
            out = {}
            t0 = time.perf_counter()
            for k in keys:
                entry = self._entries.pop(k)
                if entry.patch_state is None:
                    self.stats["patch_drops"] += 1
                    continue
                ps = entry.patch_state
                res = ps.apply(delta)
                prev = entry.gt
                entry.gt = ps.to_graph_tensors(
                    prev=None if res.rebuilt else prev, pairs=res.pairs,
                    device=prev.device)
                entry.version = new_version
                if features is not None and entry.h_grouped is not None:
                    entry.h_grouped = _group(entry.gt, features)
                self._entries[(graph_key, new_version) + k[2:]] = entry
                self.stats["patches"] += 1
                if res.rebuilt:
                    self.stats["patch_rebuilds"] += 1
                out[k[2:]] = (entry, res)
            self.stats["patch_ms_total"] += (time.perf_counter() - t0) * 1e3
            return out

    def evict(self, graph_key=None) -> None:
        """Drop entries for one graph_key, or everything when None."""
        with self._lock:
            if graph_key is None:
                self._entries.clear()
                return
            for key in [k for k in self._entries if k[0] == graph_key]:
                del self._entries[key]
