"""Signature-keyed GraphTensors store (GNNIE-style graph-specific caching).

The expensive compile-time artifact is the sharded, normalization-baked
:class:`~repro_torch.core.engines.GraphTensors` (+ shard-grouped
features) on the device. One entry is keyed on ``(graph_key, normalize,
self_loops, shard_n, device)`` — the signature
:func:`repro_torch.gnn.models.graph_signature` assigns each architecture
— so models with the same signature share one build. Entries are
LRU-evicted at a configurable capacity. Builds are immutable: streaming
graph updates come later (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.engines import GraphTensors
from repro_torch.gnn.models import graph_signature


@dataclasses.dataclass
class GraphEntry:
    gt: GraphTensors
    h_grouped: torch.Tensor | None   # (S, n, F) shard-grouped features
    built_ms: float


class GraphStore:
    """LRU cache of sharded graph builds, keyed by normalization signature."""

    def __init__(self, max_entries: int = 8):
        # shared by the serving engine's step path and direct compiles:
        # fetch-or-build is atomic, so two threads never both pay a build
        self._lock = threading.RLock()
        self._entries: OrderedDict[tuple, GraphEntry] = OrderedDict()
        self.max_entries = max_entries
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "built_ms_total": 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, graph_key, edges: np.ndarray, num_nodes: int,
            shard_n: int, arch: str, features: np.ndarray | None = None,
            *, device: torch.device) -> GraphEntry:
        """Fetch-or-build the GraphTensors for ``arch``'s signature on
        ``device``. Features are grouped once and cached alongside; an
        entry built featureless gains them on the first featureful get."""
        from repro_torch.runtime.forward import build_graph_tensors

        norm, loops = graph_signature(arch)
        key = (graph_key, norm, loops, shard_n, str(device))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats["hits"] += 1
                self._entries.move_to_end(key)
            else:
                self.stats["misses"] += 1
                t0 = time.perf_counter()
                gt = build_graph_tensors(edges, num_nodes, shard_n, arch,
                                         device)
                entry = GraphEntry(gt=gt, h_grouped=None,
                                   built_ms=(time.perf_counter() - t0) * 1e3)
                self.stats["built_ms_total"] += entry.built_ms
                self._entries[key] = entry
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.stats["evictions"] += 1
            if entry.h_grouped is None and features is not None:
                entry.h_grouped = entry.gt.group(
                    torch.as_tensor(features, dtype=torch.float32,
                                    device=device))
            return entry

    def evict(self, graph_key=None) -> None:
        """Drop entries for one graph_key, or everything when None."""
        with self._lock:
            if graph_key is None:
                self._entries.clear()
                return
            for key in [k for k in self._entries if k[0] == graph_key]:
                del self._entries[key]
