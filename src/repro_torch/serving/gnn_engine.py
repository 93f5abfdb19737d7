"""GNN node-classification engine: the compile/cache core under the Server.

Requests name a registered graph + model and a set of node ids. The engine
implements the serving :class:`~repro_torch.serving.api.Engine` step
protocol — ``route`` validates a request and streams it by (model, graph),
``step`` answers one formed micro-batch from a compiled
:class:`repro_torch.runtime.Executable`, cached per (model, graph). Two
caches sit under it:

  * **graph-tensor cache** — a private
    :class:`repro_torch.runtime.GraphStore` keyed on ``(graph, normalize,
    self_loops, shard_n, device)``, so models sharing a signature share
    one sharded build on the card;
  * **logits cache** — each Executable computes class probabilities for
    ALL nodes once (:meth:`Executable.full_probs`); every later node id
    on that pair is a host-side gather. Invalidate with
    :meth:`GNNServeEngine.invalidate` after a weight swap.

``mesh=`` (a ``(data, model)`` mesh from
:func:`repro_torch.launch.mesh.make_mesh_for`) makes every compiled unit
a sharded Executable (:mod:`repro_torch.dist.gnn`) computing the same
full-graph logits across the mesh (``launch/serve.py --mesh N``); only
the archs the sharded program supports are admitted.

``streaming=True`` serves a live graph: builds go through
:class:`~repro_torch.graphs.patch.PatchState` (slack-slot edge capacity),
and :meth:`GNNServeEngine.mutate` (driven by ``Server.mutate``) applies a
:class:`~repro_torch.graphs.delta.GraphDelta` — patch the store, hand
every compiled Executable the post-delta tensors without recompiling,
and drop only the softmax rows the delta can change.

Latency accounting is per request: ``Prediction.engine_ms`` is the time
spent answering THAT request (the cold full-graph forward is charged to
the request that triggered it); compile time accrues to
``stats["compile_ms_total"]``. ``queue_ms`` is stamped by the Server.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.analyze.lock_sanitizer import new_lock
from repro_torch.gnn.executor import ModelPlan
from repro_torch.gnn.models import (ZooSpec, graph_signature, init_params,
                                    params_from_numpy)
from repro_torch.graphs.datasets import GraphData
from repro_torch.graphs.delta import (affected_nodes, apply_to_graph_data,
                                      seed_nodes, touched_nodes)
from repro_torch.graphs.patch import pair_rows
from repro_torch.runtime.executable import validate_params_like


@dataclasses.dataclass
class NodeRequest:
    """Classify ``node_ids`` of ``graph`` with ``model``."""

    graph: str
    node_ids: np.ndarray            # (k,) int
    model: str = "gcn"


@dataclasses.dataclass
class Prediction:
    graph: str
    model: str
    node_ids: np.ndarray
    classes: np.ndarray             # (k,) int32 argmax class per node
    probs: np.ndarray               # (k,) float32 softmax mass of the argmax
    queue_ms: float = 0.0           # admission -> dispatch (Server-stamped)
    engine_ms: float = 0.0          # THIS request's engine time
    latency_ms: float = 0.0         # queue_ms + engine_ms


@dataclasses.dataclass
class _ModelEntry:
    spec: ZooSpec
    params: dict


class GNNServeEngine:
    """Batched node-classification inference over named graphs/models.

    ``device`` is where every graph build, parameter set and forward
    lives (``cuda`` unless the caller names another); ``backend`` is
    pinned into every compiled Executable (``cuda`` kernels by default,
    or ``reference``). ``plan`` is every compile's plan source:
    ``"analytic"`` or ``"autotune"`` (each (model, graph) pair measures
    up to ``tune_budget`` candidate plans on ``device`` at its first
    compile; winners are memoized through ``REPRO_PLAN_CACHE``).
    ``streaming`` builds mutable graphs with ``edge_slack`` slack
    capacity; ``invalidation`` is ``"targeted"`` (drop the delta's k-hop
    affected softmax rows) or ``"full"`` (flush per mutate). ``mesh``
    compiles sharded Executables on that mesh (and its device, unless
    ``device`` names it), with ``partition`` (``"contiguous"`` or
    ``"fennel"``) and ``hub_cache``; a mesh cannot be autotuned."""

    def __init__(self, *, device: torch.device | str | None = None,
                 max_graph_entries: int = 8, max_shard_n: int = 1024,
                 max_dense_gib: float = 8.0, backend: str | None = None,
                 mesh=None, partition: str = "contiguous",
                 hub_cache: int = 256, plan: str = "analytic",
                 tune_budget: int = 16, streaming: bool = False,
                 edge_slack: float = 0.25, invalidation: str = "targeted"):
        if plan not in ("analytic", "autotune"):
            raise ValueError(f"plan must be 'analytic' or 'autotune', "
                             f"got {plan!r}")
        if partition not in ("contiguous", "fennel"):
            raise ValueError(f"partition must be 'contiguous' or 'fennel', "
                             f"got {partition!r}")
        if invalidation not in ("targeted", "full"):
            raise ValueError(f"invalidation must be 'targeted' or 'full', "
                             f"got {invalidation!r}")
        if plan == "autotune" and mesh is not None:
            raise ValueError("plan='autotune' cannot tune sharded (mesh=) "
                             "execution; use plan='analytic' with mesh")
        self.device = runtime.resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.mesh = mesh
        self.partition = partition
        self.hub_cache = hub_cache
        # registries + compiled units: mutated only by register_*,
        # reload_params and mutate, all of which the Server serializes
        # with engine steps (Server._step_lock); documented-invariant
        # attributes, verified by the concurrency pass
        self._graphs: dict[str, GraphData] = {}       # guarded-by: Server._step_lock
        self._models: dict[str, _ModelEntry] = {}     # guarded-by: Server._step_lock
        self._store = runtime.GraphStore(max_entries=max_graph_entries)
        self._executables: dict[tuple[str, str],
                                runtime.Executable] = {}  # guarded-by: Server._step_lock
        self.max_shard_n = max_shard_n
        self.max_dense_gib = max_dense_gib
        self.backend = backend
        self.plan_source = plan
        self.tune_budget = tune_budget
        self.streaming = streaming
        self.edge_slack = edge_slack
        self.invalidation = invalidation
        self._graph_versions: dict[str, int] = {}  # guarded-by: Server._step_lock
        # per-graph accumulated delta-touched node ids, drained by the
        # stream trainer (take_dirty) from its own thread without the
        # step lock: mutate's read-union-write and the pop must not race
        self._dirty_lock = new_lock("GNNServeEngine._dirty_lock")
        self._dirty: dict[str, np.ndarray] = {}  # guarded-by: _dirty_lock
        self._stats = {  # guarded-by: Server._step_lock (step/reload/mutate serialized)
            "logits_cache_hits": 0, "logits_cache_misses": 0,
            "requests": 0, "batches": 0, "nodes_served": 0,
            "compiles": 0, "compile_ms_total": 0.0,
            "reloads": 0, "logits_invalidations": 0,
            "mutations": 0, "mutate_ms_total": 0.0,
            "targeted_invalidations": 0, "full_invalidations": 0,
            "nodes_invalidated": 0, "graph_recompiles": 0,
        }

    @property
    def stats(self) -> dict:
        """Serving counters merged with the graph-store counters."""
        s = self._store.stats
        return {**self._stats,
                "graph_cache_hits": s["hits"],
                "graph_cache_misses": s["misses"],
                "graph_cache_evictions": s["evictions"],
                "graph_built_ms_total": s["built_ms_total"],
                "graph_patches": s["patches"],
                "graph_patch_rebuilds": s["patch_rebuilds"],
                "graph_patch_drops": s["patch_drops"],
                "graph_patch_ms_total": s["patch_ms_total"]}

    @property
    def store(self) -> runtime.GraphStore:
        """The engine's graph-tensor cache (to compile beside the engine
        against the same builds)."""
        return self._store

    # -- registration ------------------------------------------------------

    def register_graph(self, name: str, data: GraphData) -> None:
        # fail fast before sharding: densified shard blocks cost
        # (padded N)² · 4 bytes of device memory
        n_pad = -(-data.profile.num_nodes // self.max_shard_n) * self.max_shard_n
        est_bytes = n_pad ** 2 * 4
        if est_bytes > self.max_dense_gib * 2 ** 30:
            raise ValueError(
                f"graph {name!r} ({data.profile.num_nodes} nodes) would "
                f"densify to ~{est_bytes / 2**30:.0f} GiB of shard blocks "
                f"(limit {self.max_dense_gib} GiB); register a scaled-down "
                f"dataset (make_dataset(..., scale=...)) or raise "
                f"max_dense_gib")
        self._graphs[name] = data
        self._graph_versions[name] = int(getattr(data, "version", 0))
        with self._dirty_lock:
            self._dirty.pop(name, None)
        # stale sharded tensors / executables for a replaced graph must go
        self._store.evict(name)
        for key in [k for k in self._executables if k[1] == name]:
            del self._executables[key]

    def register_model(self, name: str, spec: ZooSpec,
                       params: dict | None = None, *, seed: int = 0) -> None:
        """Register a model; ``params`` (numpy arrays or tensors, e.g. the
        reference package's pytree) or a fresh draw from ``seed``."""
        if params is None:
            params = init_params(spec, torch.Generator().manual_seed(seed),
                                 self.device)
        else:
            params = params_from_numpy(params, self.device)
        self._models[name] = _ModelEntry(spec=spec, params=params)
        for key in [k for k in self._executables if k[0] == name]:
            del self._executables[key]

    def invalidate(self, *, model: str | None = None,
                   graph: str | None = None) -> None:
        """Drop cached logits (e.g. after a parameter update)."""
        for (m, g), exe in self._executables.items():
            if (model is None or m == model) and (graph is None or g == graph):
                exe.invalidate()

    def reload_params(self, model: str, params: dict) -> int:
        """Hot weight reload: swap ``model``'s parameters into every
        compiled Executable without recompiling. All-or-nothing: the new
        tree is validated against the registered one before any
        Executable is touched. Each affected Executable's logits cache is
        invalidated exactly once. Drive it through
        :meth:`repro_torch.serving.api.Server.reload` so the swap is
        serialized with engine steps. Returns the number of Executables
        updated."""
        ent = self._models[model]          # KeyError for unknown models
        try:
            validate_params_like(ent.params, params)
        except ValueError as err:
            raise ValueError(
                f"reload for model {model!r} rejected: {err}") from None
        params = params_from_numpy(params, self.device)
        touched = 0
        for (m, _g), exe in self._executables.items():
            if m == model:
                exe.update_params(params)
                touched += 1
        ent.params = params
        self._stats["reloads"] += 1
        self._stats["logits_invalidations"] += touched
        return touched

    # -- streaming mutation path -------------------------------------------

    def mutate(self, graph: str, delta) -> dict:
        """Apply one :class:`~repro_torch.graphs.delta.GraphDelta` to a
        registered graph: mutate the GraphData in place (version bump),
        advance every store build through the incremental patcher, and
        hand the post-delta tensors to every compiled Executable serving
        the graph — without recompiling while the delta stays within the
        slack-slot template.

        Invalidation is **targeted** (default): only the softmax rows in
        the delta's (num_layers-1)-out-hop affected neighborhood are
        dropped (normalization-aware seeds from
        :func:`~repro_torch.graphs.delta.seed_nodes`). A compaction
        (template break), or a signature with no surviving build, drops
        the Executable instead; the next request recompiles it, counted
        in ``graph_recompiles``.

        Drive it through :meth:`repro_torch.serving.api.Server.mutate`,
        which serializes it with engine steps: an in-flight micro-batch
        finishes on the pre-delta snapshot. The report's
        ``patch_host_ms`` is the numpy patch of the store's host mirrors,
        ``patch_ms`` the whole store patch (host patch plus the device
        updates as enqueued) and ``patches`` each surviving signature's
        :class:`~repro_torch.graphs.patch.PatchResult`."""
        data = self._graphs[graph]         # KeyError for unknown graphs
        t0 = time.perf_counter()
        edges_before = np.array(data.edges, copy=True)
        num_before = data.profile.num_nodes
        apply_to_graph_data(data, delta)   # validates before first write
        old_v = self._graph_versions.get(graph, 0)
        new_v = int(data.version)
        self._graph_versions[graph] = new_v
        t_patch = time.perf_counter()
        patched = self._store.patch(graph, delta, old_version=old_v,
                                    new_version=new_v,
                                    features=data.features
                                    if delta.add_nodes else None)
        patch_ms = (time.perf_counter() - t_patch) * 1e3

        touched = touched_nodes(delta, edges_before, num_before)
        with self._dirty_lock:
            prev = self._dirty.get(graph)
            self._dirty[graph] = (touched if prev is None
                                  else np.union1d(prev, touched))

        per_model = []
        for key in [k for k in self._executables if k[1] == graph]:
            model = key[0]
            exe = self._executables[key]
            spec = self._models[model].spec
            norm, loops = graph_signature(spec.arch)
            hit = patched.get((norm, loops, exe.plan.shard_n,
                               str(self.device)))
            if hit is None:
                # no surviving build for this signature (immutable entry
                # dropped, or evicted under LRU): recompile lazily
                del self._executables[key]
                self._stats["graph_recompiles"] += 1
                per_model.append({"model": model, "recompile": True})
                continue
            entry, res = hit
            targeted = (self.invalidation == "targeted"
                        and not res.rebuilt)
            stale = None
            if targeted:
                ps = entry.patch_state
                seeds = seed_nodes(delta, edges_before, ps.edges,
                                   num_before, norm)
                stale = affected_nodes(ps.edges, seeds,
                                       len(spec.layer_dims) - 1,
                                       data.profile.num_nodes)
            try:
                rows = exe.cached_rows
                # the placement re-score hint for fennel-partitioned
                # sharded units: the patch's affected shard rows/cols
                # (available under invalidation="full" too); plain
                # executables ignore it
                refine = pair_rows(res.pairs, exe.gt.n,
                                   data.profile.num_nodes)
                n_inv = exe.update_graph(entry.gt, entry.h_grouped,
                                         stale_nodes=stale,
                                         refine_nodes=refine)
                exe.graph_version = new_v
            except ValueError:
                # compaction changed the template: drop + recompile lazily
                del self._executables[key]
                self._stats["graph_recompiles"] += 1
                per_model.append({"model": model, "recompile": True})
                continue
            if targeted:
                self._stats["targeted_invalidations"] += 1
            else:
                self._stats["full_invalidations"] += 1
            self._stats["nodes_invalidated"] += n_inv
            per_model.append({
                "model": model, "recompile": False, "targeted": targeted,
                "rows_invalidated": n_inv, "rows_cached": rows,
                "affected_nodes": int(stale.size) if stale is not None
                else data.profile.num_nodes})
        ms = (time.perf_counter() - t0) * 1e3
        self._stats["mutations"] += 1
        self._stats["mutate_ms_total"] += ms
        return {"graph": graph, "version": new_v, "ops": delta.num_ops,
                "touched_nodes": int(touched.size),
                "num_nodes": data.profile.num_nodes,
                "num_edges": data.profile.num_edges,
                "mutate_ms": ms, "patch_ms": patch_ms,
                "patch_host_ms": sum(r.apply_ms
                                     for _, r in patched.values()),
                "rebuilt": any(r.rebuilt for _, r in patched.values()),
                "patches": {k[:2]: r for k, (_, r) in patched.items()},
                "executables": per_model}

    def take_dirty(self, graph: str) -> np.ndarray:
        """Pop the accumulated delta-touched node ids for ``graph`` (the
        stream trainer's fine-tune seed pool); empty when clean."""
        with self._dirty_lock:
            return self._dirty.pop(graph, np.empty(0, dtype=np.int64))

    # -- accessors (stream trainer plumbing) -------------------------------

    def graph_data(self, name: str) -> GraphData:
        return self._graphs[name]

    def graph_version(self, name: str) -> int:
        return self._graph_versions.get(name, 0)

    def model_spec(self, name: str) -> ZooSpec:
        return self._models[name].spec

    def model_params(self, name: str) -> dict:
        return self._models[name].params

    # -- compile path ------------------------------------------------------

    def executable(self, model: str, graph: str) -> runtime.Executable:
        """Fetch-or-compile the Executable serving a (model, graph) pair."""
        key = (model, graph)
        exe = self._executables.get(key)
        if exe is None:
            ent = self._models[model]
            t0 = time.perf_counter()
            exe = runtime.compile(
                ent.spec, self._graphs[graph], device=self.device,
                params=ent.params, backend=self.backend,
                max_shard_n=self.max_shard_n, store=self._store,
                graph_key=graph, mesh=self.mesh, partition=self.partition,
                hub_cache=self.hub_cache, plan=self.plan_source,
                tune_budget=self.tune_budget,
                graph_version=self._graph_versions.get(graph, 0),
                mutable_graph=self.streaming, edge_slack=self.edge_slack)
            self._executables[key] = exe
            self._stats["compiles"] += 1
            self._stats["compile_ms_total"] += \
                (time.perf_counter() - t0) * 1e3
        return exe

    def model_plan(self, model: str, graph: str) -> ModelPlan:
        """The layer-execution plan a (model, graph) pair is compiled with."""
        return self.executable(model, graph).plan

    # -- Engine step protocol (what the Server drives) ---------------------

    def route(self, req: NodeRequest) -> tuple[str, str]:
        """Validate one request and name its stream: the (model, graph)
        pair. Raising here resolves the ticket as a typed Rejected."""
        if req.model not in self._models:
            raise KeyError(f"unknown model {req.model!r}")
        if req.graph not in self._graphs:
            raise KeyError(f"unknown graph {req.graph!r}")
        if self.mesh is not None:
            # reject here (a typed Rejected on the ticket) rather than
            # letting the compile raise inside step(), which would fail
            # every request co-batched on the stream
            from repro_torch.dist.gnn import SUPPORTED_ARCHS
            arch = self._models[req.model].spec.arch
            if arch not in SUPPORTED_ARCHS:
                raise NotImplementedError(
                    f"model {req.model!r} ({arch}) cannot run on a mesh: "
                    f"sharded execution supports {SUPPORTED_ARCHS}")
        ids = np.asarray(req.node_ids, dtype=np.int64)
        n_nodes = self._graphs[req.graph].profile.num_nodes
        if ids.size and (ids.min() < 0 or ids.max() >= n_nodes):
            raise IndexError(f"node ids out of range for graph "
                             f"{req.graph!r} ({n_nodes} nodes)")
        return (req.model, req.graph)

    def step(self, key: tuple[str, str],
             payloads: Sequence[NodeRequest]) -> list:
        """Answer one formed micro-batch (all requests share ``key``'s
        Executable). Results match ``payloads`` positionally; a request
        whose node ids went stale between admission and dispatch yields
        its ValueError positionally, failing that ticket alone."""
        model, graph = key
        exe = self.executable(model, graph)
        checked: list[np.ndarray | Exception] = []
        for r in payloads:
            try:
                checked.append(exe._check_node_ids(r.node_ids))
            except ValueError as err:
                checked.append(err)
        id_batches = [ids for ids in checked
                      if not isinstance(ids, Exception)]
        # a mutation-staled row counts as the batch's one miss: it forces
        # the same full recompute as a cold cache
        fresh = exe.has_cached_probs and all(
            exe.probs_fresh_for(ids) for ids in id_batches)
        miss = 0 if fresh or not id_batches else 1
        self._stats["logits_cache_misses"] += miss
        self._stats["logits_cache_hits"] += len(id_batches) - miss
        answers = iter(exe.step(id_batches))
        out: list = []
        for ids in checked:
            if isinstance(ids, Exception):
                out.append(ids)
                continue
            classes, probs, ms = next(answers)
            out.append(Prediction(
                graph=graph, model=model, node_ids=ids, classes=classes,
                probs=probs, engine_ms=ms, latency_ms=ms))
            self._stats["requests"] += 1
            self._stats["nodes_served"] += int(ids.size)
        self._stats["batches"] += 1
        return out

    # -- synchronous batch core --------------------------------------------

    def serve(self, requests: Sequence[NodeRequest]) -> list[Prediction]:
        """Serve a batch synchronously; answers keep the caller's request
        order. Every request is validated before any is served."""
        groups: OrderedDict[tuple[str, str], list[int]] = OrderedDict()
        for i, r in enumerate(requests):
            groups.setdefault(self.route(r), []).append(i)

        out: list[Prediction | None] = [None] * len(requests)
        for key, idxs in groups.items():
            preds = self.step(key, [requests[j] for j in idxs])
            for i, pred in zip(idxs, preds):
                out[i] = pred
        return out  # type: ignore[return-value]

    def cache_report(self) -> str:
        s = self.stats
        g_tot = s["graph_cache_hits"] + s["graph_cache_misses"]
        l_tot = s["logits_cache_hits"] + s["logits_cache_misses"]
        return (f"graph-tensor cache: {s['graph_cache_hits']}/{g_tot} hits "
                f"({len(self._store)} resident, "
                f"{s['graph_cache_evictions']} evicted, "
                f"{s['graph_built_ms_total']:.0f} ms building) | "
                f"logits cache: {s['logits_cache_hits']}/{l_tot} hits | "
                f"{s['compiles']} executables compiled "
                f"({s['compile_ms_total']:.0f} ms) | "
                f"{s['requests']} requests, {s['nodes_served']} nodes in "
                f"{s['batches']} batches")
