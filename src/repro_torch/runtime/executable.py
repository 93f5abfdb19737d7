"""The compiled unit the runtime hands back: plan + graph + params.

An :class:`Executable` owns everything needed to run one zoo model on one
graph on one device and kernel backend:

  * the :class:`~repro_torch.gnn.executor.ModelPlan`,
  * the signature-keyed :class:`~repro_torch.core.engines.GraphTensors`
    build (shared across Executables through a GraphStore),
  * full-graph (``forward``) and node-batch (``forward_nodes`` /
    ``predict``) entry points; the node-batch path is answered from a
    cached full-graph softmax, since one shard-grid sweep per layer
    covers every node. ``forward`` runs under inference mode;
    ``_forward_fn`` is the same forward with autograd, for training
    (:mod:`repro_torch.runtime.fit`),
  * streaming graph updates (``update_graph``): a delta that keeps the
    compiled template swaps in the post-delta ``GraphTensors`` — same
    Executable, plan and parameters, nothing recompiled — and drops
    only the cached softmax rows it can change (``invalidate_nodes``),
  * plan and parameter serialization (``save_plan``; ``save_params`` /
    ``load_params`` in the reference package's flat npz layout, so
    checkpoints cross between the two packages).
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.core.engines import GraphTensors
from repro_torch.gnn.executor import ModelPlan
from repro_torch.gnn.models import ZooSpec, params_from_numpy
from repro_torch.kernels.registry import KernelBackend
from repro_torch.runtime import forward as _fwd


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _leaves(tree, prefix="", out=None) -> dict:
    """{"layers": [{"w": t}]} -> {"layers/0/w": t} (leaves as they are)."""
    if out is None:
        out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _leaves(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _flatten_params(tree) -> dict:
    """{"layers": [{"w": t}]} -> {"layers/0/w": array}: numpy copies on
    the host, for writing a checkpoint."""
    return {k: v.detach().cpu().numpy()  # analyze: allow(host-sync)
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _leaves(tree).items()}


def _unflatten_params(flat: dict):
    """Inverse of :func:`_flatten_params`; digit keys become lists in
    numeric order (gaps allowed, as in a pruned checkpoint)."""
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def validate_params_like(old, new) -> None:
    """Raise ValueError unless ``new`` has the same tree structure and
    leaf shapes as ``old`` — the hot-reload contract."""
    old_flat, new_flat = _leaves(old), _leaves(new)
    if old_flat.keys() != new_flat.keys():
        raise ValueError(f"param tree mismatch: compiled "
                         f"{sorted(old_flat)}, got {sorted(new_flat)}")
    for k, o in old_flat.items():
        o_shape, n_shape = tuple(np.shape(o)), tuple(np.shape(new_flat[k]))
        if o_shape != n_shape:
            raise ValueError(f"param {k} shape mismatch: compiled "
                             f"{o_shape}, got {n_shape}")


class Executable:
    """A zoo model compiled against one graph, plan, device and backend."""

    def __init__(self, *, spec: ZooSpec, plan: ModelPlan,
                 backend: KernelBackend, gt: GraphTensors,
                 h_grouped: torch.Tensor | None, params: dict,
                 graph_key=None, plan_source: str = "analytic",
                 tune_report: dict | None = None):
        self.spec = spec
        self.plan = plan
        self.backend = backend
        self.gt = gt
        self.params = params
        self.graph_key = graph_key
        # where the plan came from ("analytic" | "autotune" |
        # "analytic_fallback") and, for tuned plans, the measurement
        # evidence (winner vs analytic ms, candidates tried), which
        # summary() shows
        self.plan_source = plan_source
        self.tune_report = tune_report
        # monotonic version of the graph this Executable serves (set by
        # runtime.compile, advanced by the serving engine's mutate path)
        self.graph_version = 0
        # the analysis Report, set by runtime.compile(analyze=...)
        self.analysis = None
        self._h_grouped = h_grouped
        self._probs: np.ndarray | None = None
        # per-row staleness of the cached softmax under targeted graph
        # invalidation; None = every cached row fresh
        self._stale: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.gt.device

    @property
    def backend_name(self) -> str:
        return self.backend.name

    # -- forward entry points ---------------------------------------------

    def _forward_fn(self):
        """``(params, h_grouped) -> (N, C)`` logits on this graph, plan and
        backend, recorded by autograd: the training step's forward, which
        runs the same kernels as :meth:`forward`."""
        spec, gt, plans, backend = (self.spec, self.gt, self.plan.layers,
                                    self.backend)
        return lambda p, h: _fwd.forward(spec, p, gt, h, plans=plans,
                                         backend=backend)

    @torch.inference_mode()
    def forward(self, params: dict | None = None,
                features: np.ndarray | torch.Tensor | None = None
                ) -> torch.Tensor:
        """Full-graph logits (N, num_classes) on the device.

        ``features`` (N, F) overrides the compiled-in graph features;
        ``params`` overrides the compiled-in parameters.
        """
        p = self.params if params is None else params
        if features is None:
            if self._h_grouped is None:
                raise ValueError("compiled without features; pass features=")
            h = self._h_grouped
        else:
            h = self.gt.group(torch.as_tensor(features, dtype=torch.float32,
                                              device=self.device))
        return self._forward_fn()(p, h)

    def _check_node_ids(self, node_ids) -> np.ndarray:
        """Validate ids against the compiled graph: a negative id would
        wrap around and return another node's prediction."""
        ids = np.asarray(node_ids, dtype=np.int64)
        if ids.size:
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= self.gt.num_nodes:
                raise ValueError(
                    f"node ids must be in [0, {self.gt.num_nodes}); got "
                    f"range [{lo}, {hi}]")
        return ids

    def forward_nodes(self, node_ids, params: dict | None = None
                      ) -> torch.Tensor:
        """Node-batch logits (k, num_classes) for ``node_ids``."""
        ids = self._check_node_ids(node_ids)
        logits = self.forward(params)
        return logits[torch.as_tensor(ids, device=self.device)]

    def full_probs(self) -> np.ndarray:
        """Cached full-graph class probabilities (N, C) on the host;
        computed once per parameter set, then every node-batch request
        is a numpy gather."""
        if self._probs is None:
            host = self.forward().cpu().numpy()  # analyze: allow(host-sync)
            self._probs = _softmax(host.astype(np.float32))
            self._stale = None      # one full recompute clears staleness
        return self._probs

    def predict(self, node_ids) -> tuple[np.ndarray, np.ndarray]:
        """(classes, probs) for a node batch from the cached softmax. A
        request touching a row staled by a graph mutation triggers ONE
        full recompute (which freshens every row); requests over fresh
        rows keep serving from the cache."""
        ids = self._check_node_ids(node_ids)
        if not self.probs_fresh_for(ids):
            self.invalidate()
        p = self.full_probs()[ids]
        return (np.argmax(p, axis=-1).astype(np.int32),
                np.max(p, axis=-1).astype(np.float32))

    def step(self, node_id_batches) -> list[tuple[np.ndarray, np.ndarray,
                                                  float]]:
        """Batch-step entry point (the serving Engine protocol's unit of
        work). Each query is timed on its own: the full-graph forward runs
        at most once, on the first cold query, and is charged to it.
        Returns ``(classes, probs, engine_ms)`` per query."""
        out = []
        for ids in node_id_batches:
            t0 = time.perf_counter()
            classes, probs = self.predict(ids)
            out.append((classes, probs, (time.perf_counter() - t0) * 1e3))
        return out

    @property
    def has_cached_probs(self) -> bool:
        return self._probs is not None

    @property
    def cached_rows(self) -> int:
        """Rows of the cached full-graph softmax (0 when none is cached)."""
        return self._probs.shape[0] if self._probs is not None else 0

    def probs_fresh_for(self, node_ids) -> bool:
        """True iff a cached softmax exists and none of ``node_ids`` was
        staled by a targeted graph invalidation — the batch can be
        answered without a forward."""
        if self._probs is None:
            return False
        if self._stale is None:
            return True
        ids = np.asarray(node_ids, dtype=np.int64)
        return not bool(self._stale[ids].any()) if ids.size else True

    def invalidate(self) -> None:
        """Drop the cached full-graph probabilities (e.g. weight swap)."""
        self._probs = None
        self._stale = None

    def invalidate_nodes(self, node_ids) -> int:
        """Targeted invalidation: mark ``node_ids`` rows of the cached
        softmax stale instead of flushing the cache. Fresh-row requests
        keep hitting; the first stale-row request pays one full-graph
        recompute. Returns the number of NEWLY staled rows (0 when
        nothing is cached)."""
        if self._probs is None:
            return 0
        ids = np.asarray(node_ids, dtype=np.int64)
        ids = np.unique(ids[(ids >= 0) & (ids < self._probs.shape[0])])
        if ids.size == 0:
            return 0
        if self._stale is None:
            self._stale = np.zeros(self._probs.shape[0], dtype=bool)
        newly = int((~self._stale[ids]).sum())
        self._stale[ids] = True
        return newly

    def update_graph(self, gt: GraphTensors,
                     h_grouped: torch.Tensor | None = None, *,
                     stale_nodes=None, refine_nodes=None) -> int:
        """Adopt post-delta graph tensors without recompiling.

        Every graph tensor must keep the compiled template (shape and
        dtype, same S and n); a compaction that changed them raises
        ValueError and the caller must recompile. ``gt`` is a new object
        (``PatchState.to_graph_tensors`` never writes into the old one),
        so the kernels' CSR indexes are built afresh from it at the next
        forward. ``stale_nodes`` (the delta's k-hop affected set) makes
        the invalidation targeted; None, or a node-count change, flushes
        the whole softmax cache. ``refine_nodes`` is a placement re-score
        hint for partitioned executables (``dist/gnn.py``), ignored here.
        Returns the number of cached rows invalidated."""
        self._check_template(gt, h_grouped)
        if h_grouped is not None:
            self._h_grouped = h_grouped
        grew = gt.num_nodes != self.gt.num_nodes
        self.gt = gt
        if stale_nodes is None or grew:
            rows = self.cached_rows
            self.invalidate()
            return rows
        return self.invalidate_nodes(stale_nodes)

    def _check_template(self, gt: GraphTensors,
                        h_grouped: torch.Tensor | None) -> None:
        """Raise ValueError unless ``gt`` (and ``h_grouped``) keep the
        compiled template: every graph tensor's shape and dtype, the grid,
        the grouped features' shape."""
        names = ("blocks", "edge_src", "edge_dst", "edge_valid")
        for name in names:
            o, nw = getattr(self.gt, name), getattr(gt, name)
            if o.shape != nw.shape or o.dtype != nw.dtype:
                raise ValueError(
                    f"graph template break: {name} was "
                    f"{tuple(o.shape)}/{o.dtype}, delta produced "
                    f"{tuple(nw.shape)}/{nw.dtype} (compaction?) — "
                    f"recompile required")
        if (gt.S, gt.n) != (self.gt.S, self.gt.n):
            raise ValueError(
                f"graph template break: grid {self.gt.S}x{self.gt.n} -> "
                f"{gt.S}x{gt.n} — recompile required")
        if h_grouped is not None and self._h_grouped is not None and \
                h_grouped.shape != self._h_grouped.shape:
            raise ValueError(
                f"feature template break: "
                f"{tuple(self._h_grouped.shape)} -> "
                f"{tuple(h_grouped.shape)} — recompile required")

    def set_params(self, params: dict) -> None:
        """Adopt ``params`` (moved to this Executable's device) and drop
        the cached probabilities; no shape check (see update_params)."""
        self.params = params_from_numpy(params, self.device)
        self.invalidate()

    def update_params(self, params: dict) -> None:
        """Hot weight reload: adopt new parameters of the same tree and
        shapes (numpy or tensors), moved to this Executable's device. The
        cached probabilities are invalidated once, as part of the swap."""
        validate_params_like(self.params, params)
        self.set_params(params)

    # -- introspection / serialization ------------------------------------

    def summary(self) -> str:
        n_params = sum(int(np.prod(np.shape(v)))
                       for v in _leaves(self.params).values())
        lines = [f"Executable[{self.spec.arch}] backend={self.backend.name} "
                 f"device={self.device} plan={self.plan_source} "
                 f"params={n_params} grid={self.gt.S}x{self.gt.S} "
                 f"n={self.gt.n}"]
        r = self.tune_report
        if r is not None:
            counts = (f"{r['candidates_measured']} candidates, "
                      f"{r['candidates_failed']} failed, "
                      f"{r.get('candidates_pruned', 0)} pruned)")
            if r.get("winner_ms") is not None:
                vs = (f"vs analytic {r['analytic_ms']:.3f} ms "
                      f"({r['speedup']:.2f}x, " if r.get("analytic_ms")
                      else "(analytic unmeasured, ")
                lines.append(f"  autotune: winner {r['winner_ms']:.3f} ms "
                             f"{vs}{counts}")
            else:
                lines.append(f"  autotune: analytic fallback ({counts}")
        lines.append(self.plan.summary())
        return "\n".join(lines)

    def plan_json(self) -> dict:
        return self.plan.to_json()

    def save_plan(self, path) -> None:
        """The plan as JSON (``ModelPlan.from_json`` reads it back, in
        either package)."""
        pathlib.Path(path).write_text(
            json.dumps(self.plan_json(), indent=2) + "\n")

    def save_params(self, path) -> None:
        """Flat npz, keys like ``layers/0/w`` — the reference layout."""
        np.savez(path, **_flatten_params(self.params))

    def load_params(self, path) -> dict:
        """Load a flat npz (written by either package) and adopt it."""
        with np.load(path) as z:
            params = _unflatten_params(dict(z))
        self.update_params(params)
        return self.params
