"""``runtime.compile(spec, graph) -> Executable`` — the one public entry.

The compile step is where the GNNerator Controller's planning lives: the
Table-I cost model picks (B, n, S, order, fused) per layer — or the
autotuner measures its top-k candidates on the device and picks the
fastest (``plan="autotune"``, :mod:`repro_torch.tune`) — the graph is
sharded + normalization-baked once per signature (shared through a
GraphStore), and parameters are initialized (or adopted) on the device,
pinned with one kernel backend. With ``mesh=`` the compiled unit is a
:class:`~repro_torch.dist.gnn.ShardedExecutable` on that mesh. With
``analyze=`` the compile-time analysis passes
(:func:`repro_torch.analyze.analyze_executable`) run over the result.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from repro_torch.core.perf_model import GNNERATOR, Platform
from repro_torch.gnn.executor import plan_model
from repro_torch.gnn.models import ZooSpec, init_params, params_from_numpy
from repro_torch.kernels import registry
from repro_torch.runtime.cache import GraphStore, count, default_store
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
                      features: np.ndarray | None = None,
                      version: int = 0) -> str:
    """Cheap content key for an unnamed graph: shape/dtype plus a strided
    sample of the edge list and the feature matrix, hex-equal to the
    reference's. ``version`` (a GraphData's monotonic mutation counter)
    is folded in because the strided sample alone collides for a graph
    mutated in place: a delta that keeps the edge count and misses every
    sampled row gives the same bytes, and a pre-delta build would be
    served for the post-delta graph."""
    h = hashlib.sha1()
    edges = np.ascontiguousarray(edges)
    step = max(1, edges.shape[0] // 1024)
    h.update(str((edges.shape, str(edges.dtype), num_nodes,
                  int(version))).encode())
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
            platform: Platform = GNNERATOR,
            backend: str | registry.KernelBackend | None = None,
            op_backends: dict[str, str | registry.KernelBackend] | None = None,
            params: dict | None = None,
            seed: int = 0,
            max_shard_n: int = 1024,
            block_candidates: tuple[int, ...] | None = None,
            store: GraphStore | None = None,
            graph_key=None,
            graph_version: int | None = None,
            mutable_graph: bool = False,
            edge_slack: float = 0.25,
            plan: str = "analytic",
            tune_budget: int = 16,
            tune_seed: int = 0,
            tune_reps: int = 3,
            tune_warmup: int = 1,
            tune_timeout_s: float | None = 30.0,
            plan_cache_dir=None,
            mesh=None,
            partition: str = "contiguous",
            hub_cache: int = 256,
            analyze: str | None = None) -> Executable:
    """Plan, shard and place one zoo model for one graph.

    Args:
      spec: the :class:`~repro_torch.gnn.models.ZooSpec` to compile
        (any of ``ARCHS``).
      graph: a :class:`~repro_torch.graphs.datasets.GraphData` or an
        ``(edges, num_nodes[, features])`` tuple.
      device: where the graph, parameters and forward live; None is
        ``cuda`` (and raises without a card).
      platform: the performance-model platform the planner optimizes for.
      backend: ``"cuda"`` (default: the hand-written kernels) or
        ``"reference"`` (the plain PyTorch versions), any other registered
        name, or a backend object. None reads ``REPRO_KERNEL_BACKEND``
        (then ``cuda``).
      op_backends: per-op overrides ``{op: backend}`` over
        ``registry.OP_NAMES`` (e.g. ``{"gather_aggregate":
        "reference"}``); the Executable is pinned to a
        :func:`~repro_torch.kernels.registry.composite_backend`.
      params: adopt a parameter tree (numpy arrays or tensors); None
        draws one from ``seed`` with a ``torch.Generator``.
      max_shard_n: planner cap on nodes per shard.
      block_candidates: the planner's feature-block candidates (default:
        the planner's own).
      store: GraphStore for the signature-keyed graph build; None uses
        the module-wide :func:`~repro_torch.runtime.cache.default_store`,
        so standalone compiles of one graph share its builds (up to 8,
        kept on the device until ``default_store().evict()``).
      graph_key: cache key naming the graph contents (default: a
        fingerprint of the edge list and features).
      graph_version: monotonic mutation generation of the graph; None
        reads ``graph.version`` (0 for frozen graphs). Folded into the
        GraphStore key and the default fingerprint, so a graph mutated
        in place never hits a pre-delta build.
      mutable_graph: build the GraphTensors through a
        :class:`repro_torch.graphs.patch.PatchState` with ``edge_slack``
        slack capacity, so streaming deltas (``GraphStore.patch`` /
        ``Executable.update_graph``) stay within the compiled template.
      plan: plan source — ``"analytic"`` trusts the Table-I cost model;
        ``"autotune"`` measures the analytic top-k candidates with the
        resolved backend on ``device``
        (:func:`repro_torch.tune.autotune_plan`) and compiles the
        measured winner, memoized under a key that names the backend
        and the device.
      tune_budget / tune_seed / tune_reps / tune_warmup / tune_timeout_s:
        autotuner knobs (max candidates measured; memo-key seed;
        median-of-k reps; warm-up runs; per-candidate timeout). Ignored
        for ``plan="analytic"``.
      plan_cache_dir: persist/load plans (and autotuned winners) as JSON
        (default: the ``REPRO_PLAN_CACHE`` environment variable).
      mesh: a ``(data, model)`` mesh (:mod:`repro_torch.dist.mesh`, e.g.
        ``launch.mesh.make_mesh_for(8, model_parallel=2)``): compile a
        :class:`~repro_torch.dist.gnn.ShardedExecutable` whose forward
        runs across it (gcn, sage_mean and gin; the others raise
        ``NotImplementedError``). The graph lives on the mesh's device
        (``device``, if given, must name it). Mesh compiles key the plan
        memo on the partition method; ``plan="autotune"`` cannot tune a
        sharded forward and raises ``ValueError``.
      partition: the data-axis placement on a mesh: ``"contiguous"``
        dst-row ranges or the ``"fennel"`` locality partitioner with a
        replicated ``hub_cache``-vertex hub cache (ignored without a
        mesh). Mutable graphs get ``edge_slack`` headroom on fennel's
        send capacities, so streaming deltas re-partition in template.
      analyze: run the compile-time analysis passes
        (:func:`repro_torch.analyze.analyze_executable` — build
        stability, dtype, plan legality, the comm contract on a mesh)
        over the compiled result. ``None``/``"off"`` skips; ``"warn"``
        attaches the report as ``exe.analysis`` and issues a
        ``UserWarning`` for warning-or-worse findings; ``"error"``
        additionally raises :class:`repro_torch.analyze.AnalysisError`
        on any error finding.
    """
    if plan not in ("analytic", "autotune"):
        raise ValueError(f"plan must be 'analytic' or 'autotune', "
                         f"got {plan!r}")
    if analyze not in (None, "off", "warn", "error"):
        raise ValueError(f"analyze must be None, 'off', 'warn' or "
                         f"'error', got {analyze!r}")
    if partition not in ("contiguous", "fennel"):
        raise ValueError(f"partition must be 'contiguous' or 'fennel', "
                         f"got {partition!r}")
    if mesh is not None:
        if plan == "autotune":
            raise ValueError(
                "plan='autotune' measures the single-device forward and "
                "cannot tune sharded (mesh=) execution yet; compile with "
                "plan='analytic' on a mesh")
        if device is None:
            device = mesh.device
        elif torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
    dev = resolve_device(device)
    count("compiles")
    edges, num_nodes, features = _as_graph(graph)
    # precedence per op: explicit op_backends > explicit backend arg >
    # REPRO_KERNEL_BACKEND_<OP> env > global env > default. An explicit
    # backend arg deliberately beats the per-op env vars; when none is
    # given, the env overrides must survive into the pinned Executable.
    per_op = dict(op_backends or {})
    if backend is None:
        for op in registry.OP_NAMES:
            env = os.environ.get(f"REPRO_KERNEL_BACKEND_{op.upper()}")
            if env and op not in per_op:
                per_op[op] = env
    be = registry.resolve(backend)
    if per_op:
        be = registry.composite_backend(be, per_op)
    if graph_version is None:
        graph_version = int(getattr(graph, "version", 0))
    if graph_key is None:
        graph_key = graph_fingerprint(edges, num_nodes, features,
                                      version=graph_version)
    if store is None:
        store = default_store()
    if params is None:
        params = init_params(spec, torch.Generator().manual_seed(seed), dev)
    else:
        params = params_from_numpy(params, dev)

    plan_kw = dict(platform=platform, max_n=max_shard_n)
    if block_candidates is not None:
        plan_kw["block_candidates"] = tuple(block_candidates)
    if mesh is not None:
        # the per-layer plan drives the sharded program's exchanges, so a
        # contiguous-keyed plan is never served for a fennel compile (and
        # vice versa)
        plan_kw["scope"] = {
            "mesh_partition": partition,
            "hub_cache": int(hub_cache) if partition == "fennel" else 0}
    plan_source, tune_report = "analytic", None
    if plan == "autotune":
        from repro_torch import tune
        rec = tune.autotune_plan(
            spec, edges, num_nodes, backend=be, device=dev,
            features=features, params=params, budget=tune_budget,
            seed=tune_seed, reps=tune_reps, warmup=tune_warmup,
            timeout_s=tune_timeout_s, cache_dir=plan_cache_dir,
            store=store, graph_key=graph_key, graph_version=graph_version,
            **plan_kw)
        mplan, plan_source, tune_report = rec.plan, rec.plan_source, \
            rec.report()
    else:
        mplan = plan_model(spec, num_nodes, int(edges.shape[0]),
                           cache_dir=plan_cache_dir, **plan_kw)
    entry = store.get(graph_key, edges, num_nodes, mplan.shard_n, spec.arch,
                      features=features, device=dev, version=graph_version,
                      mutable=mutable_graph, edge_slack=edge_slack)
    kw = dict(spec=spec, plan=mplan, backend=be, gt=entry.gt,
              h_grouped=entry.h_grouped, params=params, graph_key=graph_key,
              plan_source=plan_source, tune_report=tune_report)
    if mesh is not None:
        from repro_torch.dist.gnn import ShardedExecutable

        exe: Executable = ShardedExecutable(
            mesh=mesh, partition=partition, hub_cache=hub_cache,
            partition_slack=edge_slack if mutable_graph else 0.0, **kw)
    else:
        exe = Executable(**kw)
    exe.graph_version = graph_version

    if analyze in ("warn", "error"):
        from repro_torch import analyze as _analyze
        report = _analyze.analyze_executable(exe)
        exe.analysis = report
        if analyze == "error" and report.failed("error"):
            raise _analyze.AnalysisError(report)
        if report.at_least("warning"):
            import warnings
            warnings.warn(f"static analysis of the compiled "
                          f"{spec.arch} executable:\n{report.render()}",
                          stacklevel=2)
    return exe
