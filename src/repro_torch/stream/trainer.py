"""Train-while-serve: continuous fine-tuning around mutated neighborhoods.

The port of ``repro.stream.trainer``. Graph deltas land through
:meth:`repro_torch.serving.api.Server.mutate`; :class:`StreamTrainer`
draws :class:`~repro_torch.graphs.sampler.NeighborSampler` mini-batches
seeded from the recently mutated neighborhoods (the engine's dirty log),
takes a few train steps on its own compiled unit, and hot-reloads the
weights into serving through :meth:`~repro_torch.serving.api.Server.reload`
— so the server answers on a consistent snapshot at every instant.

The trainer owns ONE :class:`~repro_torch.runtime.fit.TrainableExecutable`
over the engine's own GraphStore (the patched build serving uses, never a
second shard). Each round refreshes its graph with
:meth:`~repro_torch.runtime.executable.Executable.update_graph` and swaps
the sampler with
:meth:`~repro_torch.runtime.fit.TrainableExecutable.update_sampler`; only
a compaction that breaks a template forces a rebuild, counted in
``stats["rebuilds"]``. (The reference also counts its jitted step's
traces; nothing is traced here.)

The trainer is synchronous: call :meth:`round` from the thread that
drives the mutations (``launch/stream.py``). Only the weight push goes
through the server's step lock.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from repro_torch import runtime
from repro_torch.graphs.delta import affected_nodes
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.runtime.fit import TrainableExecutable
from repro_torch.training.optimizer import AdamWConfig, tree_map


def _copy(params: dict) -> dict:
    return tree_map(lambda t: t.detach().clone(), params)


class StreamTrainer:
    """Continuous fine-tune loop over one served (model, graph) pair."""

    def __init__(self, server, *, graph: str, model: str,
                 batch_nodes: int = 32, fanout: tuple[int, ...] = (5, 5),
                 steps_per_round: int = 10, lr: float = 1e-2,
                 seed: int = 0, log: Callable[[str], None] = print):
        self.server = server
        self.engine = server.engine
        if not hasattr(self.engine, "mutate"):
            raise TypeError("StreamTrainer needs the GNN serving engine")
        self.graph = graph
        self.model = model
        self.batch_nodes = int(batch_nodes)
        self.fanout = tuple(int(f) for f in fanout)
        self.steps_per_round = int(steps_per_round)
        self.opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0, grad_clip=0.0,
                                   schedule="constant", warmup_steps=0)
        self.seed = int(seed)
        self.log = log
        self._trainable: TrainableExecutable | None = None
        self._budget: int | None = None
        self._round = 0
        # one writer: round() runs on the mutation-driving thread
        self.stats = {"rounds": 0, "rounds_skipped": 0, "steps": 0,
                      "reloads": 0, "rebuilds": 0}

    # -- construction ------------------------------------------------------

    def _sampler(self, data, seed_ids: np.ndarray) -> NeighborSampler:
        return NeighborSampler(
            data.edges, data.profile.num_nodes,
            batch_nodes=self.batch_nodes, fanout=self.fanout,
            seed_ids=seed_ids, budget=self._budget,
            seed=self.seed + self._round)

    def _seed_pool(self, data, dirty: np.ndarray) -> np.ndarray:
        """Train-mask nodes inside the 1-hop out-neighborhood of the
        delta-touched set; the full train set when that pool is too thin
        to fill a batch."""
        n = data.profile.num_nodes
        if dirty.size:
            pool = affected_nodes(data.edges, dirty, 1, n)
            pool = pool[data.train_mask[pool]]
            if pool.size >= self.batch_nodes:
                return pool
        return np.flatnonzero(data.train_mask)

    def _build(self, data, seed_ids: np.ndarray) -> None:
        """(Re)compile the trainer's executable and trainable unit over
        the engine's GraphStore, at the graph's current version."""
        eng = self.engine
        exe = runtime.compile(
            eng.model_spec(self.model), data, device=eng.device,
            params=eng.model_params(self.model), backend=eng.backend,
            max_shard_n=eng.max_shard_n, store=eng.store,
            graph_key=self.graph, graph_version=eng.graph_version(self.graph),
            mutable_graph=eng.streaming, edge_slack=eng.edge_slack)
        if self._budget is None:
            self._budget = NeighborSampler(
                data.edges, data.profile.num_nodes,
                batch_nodes=self.batch_nodes, fanout=self.fanout,
                seed_ids=np.flatnonzero(data.train_mask),
                seed=self.seed).budget
        self._trainable = TrainableExecutable(
            exe, data.labels, train_mask=data.train_mask,
            features=data.features, opt_cfg=self.opt_cfg,
            sampler=self._sampler(data, seed_ids))

    # -- one fine-tune round -----------------------------------------------

    def round(self, *, force: bool = False) -> dict:
        """Drain the engine's dirty log, retarget sampling at those
        neighborhoods, take ``steps_per_round`` optimizer steps and
        hot-reload the weights into serving. Skips (no training) when
        nothing mutated since the last round, unless ``force``."""
        t0 = time.perf_counter()
        eng = self.engine
        data = eng.graph_data(self.graph)
        dirty = eng.take_dirty(self.graph)
        if dirty.size == 0 and self._trainable is not None and not force:
            self.stats["rounds_skipped"] += 1
            return {"round": self._round, "skipped": True}

        seed_ids = self._seed_pool(data, dirty)
        if self._trainable is None:
            self._build(data, seed_ids)
        tr = self._trainable
        exe = tr.executable

        # refresh the trainer's graph from the (patched) store: a NEW
        # GraphTensors, so its CSR indexes are rebuilt, shared with the
        # serving executables of the same signature
        entry = eng.store.get(
            self.graph, data.edges, data.profile.num_nodes,
            exe.plan.shard_n, tr.spec.arch, features=data.features,
            device=eng.device, version=eng.graph_version(self.graph),
            mutable=eng.streaming, edge_slack=eng.edge_slack)
        try:
            exe.update_graph(entry.gt, entry.h_grouped)
            tr.update_sampler(self._sampler(data, seed_ids),
                              features=data.features, labels=data.labels,
                              train_mask=data.train_mask)
        except ValueError:
            # compaction / template break: one rebuild, then continue
            self.stats["rebuilds"] += 1
            self._build(data, seed_ids)
            tr = self._trainable

        history = tr.run(self.steps_per_round, log=lambda s: None)

        # a copy for serving: the trainer's next round must never touch
        # the weights the server holds before that round's own reload
        params = _copy(tr.params)
        self.server.reload(lambda e: e.reload_params(self.model, params))

        self._round += 1
        self.stats["rounds"] += 1
        self.stats["steps"] += self.steps_per_round
        self.stats["reloads"] += 1
        acc = tr.train_accuracy()
        report = {"round": self._round - 1, "skipped": False,
                  "dirty_nodes": int(dirty.size),
                  "seed_pool": int(seed_ids.size),
                  "loss": history[-1][1] if history else None,
                  "train_acc": acc,
                  "round_ms": (time.perf_counter() - t0) * 1e3}
        self.log(f"[stream.trainer] round {report['round']}: "
                 f"dirty={report['dirty_nodes']} "
                 f"pool={report['seed_pool']} "
                 f"loss={report['loss']:.4f} acc={acc:.3f} "
                 f"({report['round_ms']:.0f} ms)")
        return report

    def train_accuracy(self) -> float:
        """Full-graph train-mask accuracy of the CURRENT weights (builds
        the trainable on first use)."""
        if self._trainable is None:
            data = self.engine.graph_data(self.graph)
            self._build(data, self._seed_pool(
                data, np.empty(0, dtype=np.int64)))
        return self._trainable.train_accuracy()
