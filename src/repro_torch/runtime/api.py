"""``runtime.compile(spec, graph) -> Executable`` — the one public entry.

The compile step is where the GNNerator Controller's planning lives: the
Table-I cost model picks (B, n, S, order, fused) per layer, the graph is
sharded + normalization-baked once per signature (shared through a
GraphStore), and parameters are initialized (or adopted) on the device,
pinned with one kernel backend.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.gnn.executor import plan_model
from repro_torch.gnn.models import ZooSpec, init_params, params_from_numpy
from repro_torch.kernels import registry
from repro_torch.runtime.cache import GraphStore
from repro_torch.runtime.executable import Executable


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a card a CUDA request raises — nothing falls back
    to the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def graph_fingerprint(edges: np.ndarray, num_nodes: int,
                      features: np.ndarray | None = None) -> str:
    """Cheap content key for an unnamed graph: shape/dtype plus a strided
    sample of the edge list and the feature matrix."""
    h = hashlib.sha1()
    edges = np.ascontiguousarray(edges)
    step = max(1, edges.shape[0] // 1024)
    h.update(str((edges.shape, str(edges.dtype), num_nodes)).encode())
    h.update(edges[::step].tobytes())
    if features is not None:
        feats = np.ascontiguousarray(features)
        fstep = max(1, feats.shape[0] // 256)
        h.update(str((feats.shape, str(feats.dtype))).encode())
        h.update(feats[::fstep].tobytes())
    return h.hexdigest()


def _as_graph(graph):
    """Accept a GraphData, or (edges, num_nodes[, features])."""
    if hasattr(graph, "edges") and hasattr(graph, "profile"):
        return graph.edges, graph.profile.num_nodes, graph.features
    if isinstance(graph, (tuple, list)):
        if len(graph) == 2:
            edges, num_nodes = graph
            return np.asarray(edges), int(num_nodes), None
        edges, num_nodes, features = graph
        return np.asarray(edges), int(num_nodes), features
    raise TypeError(
        f"graph must be a GraphData or (edges, num_nodes[, features]) "
        f"tuple, got {type(graph).__name__}")


def compile(spec: ZooSpec, graph, *,
            device: torch.device | str | None = None,
            backend: str | registry.KernelBackend | None = None,
            params: dict | None = None,
            seed: int = 0,
            max_shard_n: int = 1024,
            store: GraphStore | None = None,
            graph_key=None) -> Executable:
    """Plan, shard and place one zoo model for one graph.

    Args:
      spec: the :class:`~repro_torch.gnn.models.ZooSpec` to compile
        (any of ``ARCHS``).
      graph: a :class:`~repro_torch.graphs.datasets.GraphData` or an
        ``(edges, num_nodes[, features])`` tuple.
      device: where the graph, parameters and forward live; None is
        ``cuda`` (and raises without a card).
      backend: ``"cuda"`` (default: the hand-written kernels) or
        ``"reference"`` (the plain PyTorch versions), or a backend object.
      params: adopt a parameter tree (numpy arrays or tensors); None
        draws one from ``seed`` with a ``torch.Generator``.
      max_shard_n: planner cap on nodes per shard.
      store: GraphStore for the signature-keyed graph build; None uses a
        private one (nothing outlives the Executable).
      graph_key: cache key naming the graph contents (default: a
        fingerprint of the edge list and features).
    """
    dev = resolve_device(device)
    edges, num_nodes, features = _as_graph(graph)
    be = registry.resolve(backend)
    if graph_key is None:
        graph_key = graph_fingerprint(edges, num_nodes, features)
    if store is None:
        store = GraphStore()
    if params is None:
        params = init_params(spec, torch.Generator().manual_seed(seed), dev)
    else:
        params = params_from_numpy(params, dev)

    plan = plan_model(spec, num_nodes, int(edges.shape[0]), max_n=max_shard_n)
    entry = store.get(graph_key, edges, num_nodes, plan.shard_n, spec.arch,
                      features=features, device=dev)
    return Executable(spec=spec, plan=plan, backend=be, gt=entry.gt,
                      h_grouped=entry.h_grouped, params=params,
                      graph_key=graph_key)
