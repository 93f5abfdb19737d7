"""End-to-end GNN training over compiled Executables (``runtime.fit``).

The port of ``repro.runtime.fit``. A training step runs the same forward
as serving, through the same kernels (on the card, the hand-written
ones), recorded by autograd; each kernel's backward is autograd of its
plain version, as the reference differentiates its oracles
(``kernels/registry.py``: ``_with_plain_vjp``)::

    result = runtime.fit(spec, graph, steps=200)
    result.executable.predict([0, 7, 9])     # serves the trained weights

:class:`TrainableExecutable` wraps one compiled
:class:`~repro_torch.runtime.executable.Executable` with an AdamW train
step (:mod:`repro_torch.training.optimizer`) in two regimes:

  * **full-batch** — masked cross-entropy over the full-graph forward,
    on one device or (``mesh=``) data-parallel over a sharded
    Executable (:mod:`repro_torch.dist.gnn`): the loss enters once per
    data group, autograd runs the collectives' transposes, and the
    replicated parameters' gradients are all-reduced over the mesh
    (:meth:`TrainableExecutable.train_comm_stats` counts all three);
  * **mini-batch** — a :class:`~repro_torch.graphs.sampler.NeighborSampler`
    draws fixed-budget subgraphs; each is sharded to one (S, n) grid
    (the planner's, as in the reference) and its edge lists padded to
    one cap, so every step runs the same shapes. Each step's subgraph
    is new, so each step builds its own CSR indexes.

The loop is :class:`~repro_torch.training.train_loop.TrainLoop`:
periodic and preemption checkpoints, deterministic resume (the sampler
is seeded by step), straggler log.

:meth:`TrainableExecutable.update_sampler` swaps the sampler (and the
node data) between rounds of the streaming fine-tune
(:mod:`repro_torch.stream.trainer`) while the mini-batch template holds.

``plan="autotune"`` trains with the plan the autotuner measured fastest
on the device (:mod:`repro_torch.tune`), so training runs the tuned
plan's kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engines import GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.executor import plan_model
from repro_torch.gnn.models import ZooSpec, graph_signature, params_from_numpy
from repro_torch.graphs.sampler import NeighborSampler, SubgraphBatch
from repro_torch.runtime import forward as _fwd
from repro_torch.runtime.executable import (Executable, _flatten_params,
                                            _unflatten_params)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, make_schedule,
                                            tree_leaves, tree_map,
                                            tree_unflatten)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over ``mask``-selected nodes (f32, mask-weighted)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def _masked_accuracy(logits, labels, mask) -> torch.Tensor:
    m = mask.float()
    hit = (torch.argmax(logits, dim=-1) == labels).float()
    return torch.sum(hit * m) / torch.clamp(torch.sum(m), min=1.0)


def _pad_axis(x: np.ndarray, size: int, axis: int) -> np.ndarray:
    pad = size - x.shape[axis]
    if pad < 0:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} to {size}")
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


class TrainableExecutable:
    """A compiled Executable plus the train step that updates it.

    Functional core (``step_fn(params, opt_state, batch)``), stateful
    shell (``run()`` threads params/opt_state through
    :class:`~repro_torch.training.train_loop.TrainLoop` and leaves the
    trained weights swapped into ``self.executable``).
    """

    def __init__(self, exe: Executable, labels: np.ndarray, *,
                 train_mask: np.ndarray | None = None,
                 features: np.ndarray | None = None,
                 opt_cfg: AdamWConfig | None = None,
                 sampler: NeighborSampler | None = None):
        if exe._h_grouped is None and features is None:
            raise ValueError("training needs features: compile with a "
                             "featureful graph or pass features=")
        self.executable = exe
        self.spec: ZooSpec = exe.spec
        self.opt_cfg = opt_cfg or AdamWConfig(
            lr=5e-3, weight_decay=0.0, grad_clip=0.0, schedule="constant",
            warmup_steps=0)
        self._schedule = make_schedule(self.opt_cfg)
        # train on a copy: the Executable keeps serving its own weights
        # until run() swaps the trained ones in
        self.params = tree_map(lambda t: t.detach().clone(), exe.params)
        self.opt_state = adamw_init(self.params)
        self.sampler = sampler

        n = exe.gt.num_nodes
        labels = np.asarray(labels)
        if labels.shape[0] != n:
            raise ValueError(f"labels cover {labels.shape[0]} nodes, graph "
                             f"has {n}")
        self._labels = np.asarray(labels, dtype=np.int64)
        self._train_mask = (np.ones(n, dtype=bool) if train_mask is None
                            else np.asarray(train_mask, dtype=bool))
        self._features = features
        dev = exe.device
        if sampler is None:
            h = exe._h_grouped if exe._h_grouped is not None \
                else exe.gt.group(torch.as_tensor(features,
                                                  dtype=torch.float32,
                                                  device=dev))
            self._full_batch = (h, torch.from_numpy(self._labels).to(dev),
                                torch.from_numpy(self._train_mask).to(dev))
        else:
            if getattr(exe, "mesh", None) is not None:
                raise NotImplementedError(
                    "mini-batch training is single-device; mesh training "
                    "runs full-batch (the sampled subgraph is already the "
                    "parallelism unit)")
            if features is None:
                raise ValueError("mini-batch training needs raw features= "
                                 "(the compiled h_grouped covers the full "
                                 "graph, not sampled subgraphs)")
            self._features = np.asarray(features, dtype=np.float32)
            self._mb = self._make_minibatch_builder()

    # -- step construction -------------------------------------------------

    def _make_minibatch_builder(self) -> Callable:
        """Host side of the mini-batch path: sample -> shard -> pad to the
        fixed (S, n, E_cap) template -> upload."""
        exe, smp = self.executable, self.sampler
        norm, loops = graph_signature(self.spec.arch)
        budget = smp.budget
        est_edges = min(smp.edge_cap, budget * max(smp.fanout))
        plan = plan_model(self.spec, budget, est_edges,
                          max_n=min(exe.gt.n, budget))
        self.minibatch_plan = plan
        n_sub = plan.shard_n
        s_sub = -(-budget // n_sub)
        # per-pair cap: dense block bound (+n for stacked self loops) vs
        # total-unique-edge bound (+budget for the self loops shard_graph
        # appends on every slot)
        e_cap = min(n_sub * n_sub + n_sub, smp.edge_cap + budget)
        self._mb_shape = (s_sub, n_sub, e_cap)
        dev = exe.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def build(step: int):
            batch: SubgraphBatch = smp.sample(step)
            sg = shard_graph(batch.edges, budget, n_sub,
                             add_self_loops=loops, normalize=norm)
            feats = self._features[batch.nodes] * \
                batch.node_valid[:, None].astype(np.float32)
            h = _pad_axis(feats, s_sub * n_sub, 0).reshape(s_sub, n_sub, -1)
            labels = self._labels[batch.nodes]
            mask = batch.seed_mask & self._train_mask[batch.nodes]
            return (put(sg.blocks), put(_pad_axis(sg.edge_src, e_cap, 2)),
                    put(_pad_axis(sg.edge_dst, e_cap, 2)),
                    put(_pad_axis(sg.edge_valid, e_cap, 2)),
                    put(h), put(labels), put(mask))

        return build

    def _forward_for(self, batch) -> tuple[Callable, tuple]:
        """(forward(params, h) -> logits, (h, labels, mask)) for a batch."""
        if self.sampler is None:
            h, labels, mask = batch
            return self.executable._forward_fn(), (h, labels, mask)
        blocks, e_src, e_dst, e_valid, h, labels, mask = batch
        s_sub, n_sub, _ = self._mb_shape
        gt = GraphTensors(blocks=blocks, edge_src=e_src, edge_dst=e_dst,
                          edge_valid=e_valid, num_nodes=self.sampler.budget,
                          n=n_sub, S=s_sub)
        spec, backend = self.spec, self.executable.backend
        plans = self.minibatch_plan.layers

        def fwd(p, h):
            return _fwd.forward(spec, p, gt, h, plans=plans, backend=backend)

        return fwd, (h, labels, mask)

    def loss_and_grads(self, params, batch):
        """(loss, logits, grads) of the masked cross-entropy at
        ``params`` on ``batch``; grads has params' tree structure. On a
        mesh the gradients of the replicated parameters are all-reduced
        over it (the data-parallel reduction)."""
        fwd, (h, labels, mask) = self._forward_for(batch)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            logits = fwd(tree_unflatten(params, leaves), h)
            loss = masked_cross_entropy(logits, labels, mask)
            grads = torch.autograd.grad(loss, leaves)
        mesh = getattr(self.executable, "mesh", None)
        if mesh is not None:
            grads = mesh.reduce_gradients(list(grads))
        return (loss.detach(), logits.detach(),
                tree_unflatten(params, grads))

    def update_sampler(self, sampler: NeighborSampler, *,
                       features: np.ndarray | None = None,
                       labels: np.ndarray | None = None,
                       train_mask: np.ndarray | None = None) -> None:
        """Swap the neighbor sampler (and optionally the raw node data)
        while keeping the mini-batch template — the streaming fine-tune
        contract: each round re-aims sampling at the freshly mutated
        neighborhoods and the train step keeps its shapes.

        The new sampler must produce the compiled template: same
        ``budget``, ``batch_nodes`` and ``fanout`` (pass
        ``budget=old.budget`` when the graph grew — the default clamps at
        num_nodes). Raises ValueError on any template change; the swap
        is all-or-nothing."""
        if self.sampler is None:
            raise ValueError("update_sampler requires mini-batch mode "
                             "(constructed with sampler=)")
        old = self.sampler
        if (sampler.budget != old.budget
                or sampler.batch_nodes != old.batch_nodes
                or tuple(sampler.fanout) != tuple(old.fanout)):
            raise ValueError(
                f"sampler template mismatch: compiled (budget="
                f"{old.budget}, batch_nodes={old.batch_nodes}, fanout="
                f"{old.fanout}), got (budget={sampler.budget}, "
                f"batch_nodes={sampler.batch_nodes}, fanout="
                f"{sampler.fanout}) — a changed template needs a new "
                f"TrainableExecutable")
        prev = (self.sampler, self._features, self._labels,
                self._train_mask, self._mb, self._mb_shape,
                self.minibatch_plan)
        try:
            self.sampler = sampler
            if features is not None:
                self._features = np.asarray(features, dtype=np.float32)
            if labels is not None:
                self._labels = np.asarray(labels, dtype=np.int64)
            if train_mask is not None:
                self._train_mask = np.asarray(train_mask, dtype=bool)
            shape_before = self._mb_shape
            self._mb = self._make_minibatch_builder()
            if self._mb_shape != shape_before:
                raise ValueError(
                    f"mini-batch template changed {shape_before} -> "
                    f"{self._mb_shape}; rebuild the TrainableExecutable")
        except Exception:
            (self.sampler, self._features, self._labels, self._train_mask,
             self._mb, self._mb_shape, self.minibatch_plan) = prev
            raise

    # -- TrainLoop protocol ------------------------------------------------

    def data(self, step: int):
        """Step-indexable batch (deterministic => resume-safe)."""
        if self.sampler is None:
            return self._full_batch
        return self._mb(step)

    def step_fn(self, params, opt_state, batch):
        loss, logits, grads = self.loss_and_grads(params, batch)
        params, opt_state, stats = adamw_update(
            grads, opt_state, params, self.opt_cfg, self._schedule)
        labels, mask = batch[-2], batch[-1]
        metrics = {"loss": loss,
                   "acc": _masked_accuracy(logits, labels, mask), **stats}
        return params, opt_state, metrics

    def run(self, steps: int, *, ckpt_manager=None, ckpt_every: int = 50,
            log_every: int = 25,
            log: Callable[[str], None] = print) -> list:
        """Train to ``steps`` total (resuming from ``ckpt_manager`` if it
        holds a checkpoint), swap the trained weights into the
        Executable, and return the ``(step, loss)`` history."""
        from repro_torch.training.train_loop import TrainLoop

        loop = TrainLoop(cfg=None, opt_cfg=self.opt_cfg, data_iter=self.data,
                         ckpt_manager=ckpt_manager, ckpt_every=ckpt_every,
                         log_every=log_every)
        self.params, self.opt_state, history = loop.run(
            self.params, self.opt_state, steps, train_step=self.step_fn,
            log=log)
        if ckpt_manager is not None:
            ckpt_manager.wait()
        self.executable.update_params(self.params)
        return history

    # -- evaluation / state ------------------------------------------------

    def train_accuracy(self, params=None) -> float:
        """Full-graph accuracy over the train mask (current params)."""
        exe = self.executable
        p = self.params if params is None else params
        logits = exe.forward(
            p, features=None if self._features is None
            or exe._h_grouped is not None else self._features)
        dev = logits.device
        return float(_masked_accuracy(
            logits, torch.from_numpy(self._labels).to(dev),
            torch.from_numpy(self._train_mask).to(dev)))

    def state_dict(self) -> dict:
        """The resumable train state as one tree."""
        return {"params": self.params, "opt": self.opt_state}

    def save_state(self, path) -> None:
        """npz snapshot of params + optimizer state (flat keys, the
        layout ``Executable.save_params`` uses)."""
        np.savez(path, **_flatten_params(self.state_dict()))

    def load_state(self, path) -> dict:
        with np.load(path) as z:
            state = _unflatten_params(dict(z))
        dev = self.executable.device
        self.params = params_from_numpy(state["params"], dev)
        opt = state["opt"]
        self.opt_state = {
            "m": params_from_numpy(opt["m"], dev),
            "v": params_from_numpy(opt["v"], dev),
            "step": torch.as_tensor(np.asarray(opt["step"]),
                                    dtype=torch.int32)}
        self.executable.update_params(self.params)
        return {"params": self.params, "opt": self.opt_state}

    # -- distributed accounting --------------------------------------------

    def train_comm_stats(self) -> dict:
        """Collective traffic of one TRAIN step (mesh runs only): the
        counted per-kind wire bytes and counts of a forward, backward and
        gradient reduction at the current parameters (nothing updated),
        next to the forward all-gather model — the backward adds the
        all-gathers' transposes (reduce-scatter), the psums' (all-reduce)
        and the data-parallel gradient all-reduce."""
        exe = self.executable
        if getattr(exe, "mesh", None) is None:
            raise ValueError("train_comm_stats needs a mesh-compiled "
                             "Executable (runtime.fit(..., mesh=...))")
        with exe.mesh.comm.capture() as log:
            self.loss_and_grads(self.params, self.data(0))
        stats = log.stats()
        return {
            "measured_wire_bytes": dict(stats.wire_bytes),
            "measured_counts": dict(stats.counts),
            "forward_allgather_wire_bytes":
                sum(exe._layer_allgather_bytes()),
            "n_data": exe.n_data,
            "n_model": exe.n_model,
        }

    def verify_train_comm(self) -> dict:
        """Check that the train step's counted collectives are consistent
        with the forward model: at least the forward all-gather volume on
        the wire, plus a reduction collective carrying the data-parallel
        gradient reduction; raise AssertionError otherwise. Returns
        :meth:`train_comm_stats`."""
        cs = self.train_comm_stats()
        measured_ag = cs["measured_wire_bytes"].get("all-gather", 0.0)
        expected_fwd = cs["forward_allgather_wire_bytes"]
        if measured_ag < 0.98 * expected_fwd:
            raise AssertionError(
                f"train step all-gather wire bytes {measured_ag:,.0f} below "
                f"the forward model {expected_fwd:,.0f}")
        if cs["n_data"] * cs["n_model"] > 1:
            reduces = sum(cs["measured_counts"].get(k, 0)
                          for k in ("all-reduce", "reduce-scatter"))
            if not reduces:
                raise AssertionError(f"train step issued no reduction: "
                                     f"{cs['measured_counts']}")
        return cs


@dataclasses.dataclass
class FitResult:
    """What :func:`fit` hands back: the trained, servable Executable plus
    the train state and loss history."""

    executable: Executable
    trainable: TrainableExecutable
    params: dict
    opt_state: dict
    history: list          # (step, loss) at log_every cadence

    def train_accuracy(self) -> float:
        return self.trainable.train_accuracy()


def fit(spec: ZooSpec, graph, labels=None, *,
        train_mask=None, steps: int = 100,
        opt: AdamWConfig | None = None, lr: float = 5e-3,
        weight_decay: float = 0.0, grad_clip: float = 0.0,
        schedule: str = "constant", warmup_steps: int = 0,
        batch_nodes: int = 0, fanout: Sequence[int] = (10, 5),
        device: torch.device | str | None = None, backend=None,
        mesh=None, partition: str = "contiguous", hub_cache: int = 256,
        max_shard_n: int = 1024, plan: str = "analytic",
        tune_budget: int = 16, params: dict | None = None, seed: int = 0,
        store=None, ckpt_manager=None, ckpt_dir=None, ckpt_every: int = 50,
        log_every: int = 25, log: Callable[[str], None] = print
        ) -> FitResult:
    """Compile one zoo model and train it end to end.

    Args:
      spec: the :class:`~repro_torch.gnn.models.ZooSpec` to train.
      graph: a :class:`~repro_torch.graphs.datasets.GraphData` (labels and
        train_mask default from it) or ``(edges, num_nodes, features)``.
      labels: (N,) int class labels; required for tuple graphs.
      train_mask: (N,) bool loss mask; default: GraphData.train_mask, or
        every node.
      steps: TOTAL optimization steps — resuming from a checkpoint at k
        continues to ``steps``, exactly like an uninterrupted run.
      batch_nodes: 0 trains full-batch; > 0 neighbor-samples mini-batches
        of this many seed nodes with per-layer ``fanout``.
      device / backend: as :func:`runtime.compile` (``cuda`` and the
        hand-written kernels by default).
      mesh: a ``(data, model)`` mesh (:mod:`repro_torch.dist.mesh`):
        full-batch data-parallel training over the sharded forward (the
        gradient reduction is :meth:`TrainableExecutable.loss_and_grads`'s;
        mini-batch training on a mesh raises ``NotImplementedError``).
      partition / hub_cache: the data-axis placement for mesh training,
        as :func:`runtime.compile` (``"fennel"`` trains through the
        permuted row groups and the hub cache).
      ckpt_manager / ckpt_dir: resume + periodic checkpointing through
        :class:`~repro_torch.checkpoint.manager.CheckpointManager`.

    Everything else matches :func:`runtime.compile`.
    """
    from repro_torch.runtime import api

    if hasattr(graph, "profile"):
        if labels is None:
            labels = graph.labels
        if train_mask is None:
            train_mask = graph.train_mask
        features = graph.features
    else:
        _, _, features = api._as_graph(graph)
        if features is None:
            raise ValueError("training needs node features")
    if labels is None:
        raise ValueError("training needs labels (pass labels= or a "
                         "GraphData)")

    exe = api.compile(spec, graph, device=device, backend=backend,
                      mesh=mesh, partition=partition, hub_cache=hub_cache,
                      max_shard_n=max_shard_n, params=params, seed=seed,
                      store=store, plan=plan, tune_budget=tune_budget)
    opt_cfg = opt or AdamWConfig(
        lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
        schedule=schedule, warmup_steps=warmup_steps, total_steps=steps)

    sampler = None
    if batch_nodes:
        tm = np.asarray(train_mask, dtype=bool) if train_mask is not None \
            else np.ones(exe.gt.num_nodes, dtype=bool)
        edges_np = graph.edges if hasattr(graph, "profile") else \
            np.asarray(graph[0])
        sampler = NeighborSampler(
            edges_np, exe.gt.num_nodes, batch_nodes=batch_nodes,
            fanout=tuple(fanout), seed_ids=np.flatnonzero(tm), seed=seed)

    trainable = TrainableExecutable(
        exe, labels, train_mask=train_mask,
        features=np.asarray(features, dtype=np.float32),
        opt_cfg=opt_cfg, sampler=sampler)

    if ckpt_manager is None and ckpt_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt_manager = CheckpointManager(str(ckpt_dir), keep=3)

    history = trainable.run(steps, ckpt_manager=ckpt_manager,
                            ckpt_every=ckpt_every, log_every=log_every,
                            log=log)
    return FitResult(executable=exe, trainable=trainable,
                     params=trainable.params, opt_state=trainable.opt_state,
                     history=history)
