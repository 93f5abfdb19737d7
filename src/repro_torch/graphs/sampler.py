"""Vectorized neighbor sampling for mini-batch GNN training.

The port of ``repro.graphs.sampler`` (host numpy, no torch), held
bitwise to it for the same seed and step by tests/test_torch_train.py.

GraphSAGE-style layer-wise neighbor sampling: each step draws a batch of
seed nodes and, per layer, up to ``fanout[l]`` in-neighbors of the current
frontier (with replacement, the standard estimator), then relabels the
union into a **fixed-size** local id space. The fixed budget is the point:
every sampled subgraph shards to the same (S, n) grid and pads its edge
lists to the same cap, so every step runs the same shapes.

Sampling is deterministic per ``(seed, step)`` — the train loop's
data-by-step resume contract (checkpoint at step k, resume, and the
sampler replays the exact batches an uninterrupted run would have seen).

All sampling is numpy-vectorized (CSR gather + modular indexing); there
is no per-node Python loop, so reddit-scale frontiers stay cheap.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SubgraphBatch:
    """One sampled, locally-relabeled subgraph with fixed shapes.

    ``nodes`` maps local id -> global id for the first ``num_real`` slots;
    padding slots repeat node 0 but are isolated (no edges) and masked out
    of both the loss (``seed_mask``) and feature gather (``node_valid``).
    """

    nodes: np.ndarray        # (budget,) int64 global ids (padded)
    node_valid: np.ndarray   # (budget,) bool — real (non-padding) slots
    seed_mask: np.ndarray    # (budget,) bool — loss nodes (the seeds)
    edges: np.ndarray        # (E, 2) int64 LOCAL (src, dst), deduplicated
    num_real: int            # real node count before padding


class NeighborSampler:
    """Layer-wise in-neighbor sampler over a fixed node budget.

    Args:
      edges: (E, 2) global (src, dst) edge list (aggregation pulls along
        src -> dst, so we sample *in*-neighbors of the frontier).
      num_nodes: N.
      batch_nodes: seeds per step (the loss nodes).
      fanout: per-layer neighbor sample counts, outermost layer first —
        ``(10, 5)`` samples 10 in-neighbors per seed, then 5 per sampled
        neighbor.
      seed_ids: population the seeds are drawn from (e.g. the train-mask
        node ids); default all nodes.
      budget: fixed local node count; default the worst case
        ``batch_nodes * (1 + f1 + f1*f2 + ...)`` capped at ``num_nodes``.
      seed: RNG stream id (pairs with the step for determinism).
    """

    def __init__(self, edges: np.ndarray, num_nodes: int, *,
                 batch_nodes: int, fanout: tuple[int, ...] = (10, 5),
                 seed_ids: np.ndarray | None = None, budget: int | None = None,
                 seed: int = 0):
        edges = np.asarray(edges, dtype=np.int64)
        self.num_nodes = int(num_nodes)
        self.batch_nodes = int(batch_nodes)
        self.fanout = tuple(int(f) for f in fanout)
        if not self.fanout or any(f < 1 for f in self.fanout):
            raise ValueError(f"fanout needs >=1 per layer, got {fanout}")
        self.seed = int(seed)
        self.seed_ids = (np.arange(num_nodes, dtype=np.int64)
                         if seed_ids is None
                         else np.asarray(seed_ids, dtype=np.int64))
        if self.seed_ids.size == 0:
            raise ValueError("seed_ids is empty")
        if budget is None:
            per_seed = 1
            budget = self.batch_nodes
            for f in self.fanout:
                per_seed *= f
                budget += self.batch_nodes * per_seed
            budget = min(budget, self.num_nodes)
        self.budget = max(int(budget), self.batch_nodes)
        # worst-case deduplicated subgraph edges: each hop keeps at most
        # (kept frontier <= budget) * fanout[l] unique edges, plus a self
        # loop per slot (shard_graph may add them). sum(fanout), not
        # max(fanout): with the budget clamped at num_nodes every hop can
        # contribute its full quota between kept nodes.
        self.edge_cap = self.budget * (sum(self.fanout) + 1)

        # CSR over incoming edges: for node v, its in-neighbor sources are
        # src_sorted[indptr[v]:indptr[v+1]]
        order = np.argsort(edges[:, 1], kind="stable")
        self._src_sorted = np.ascontiguousarray(edges[order, 0])
        dst_sorted = edges[order, 1]
        self._indptr = np.searchsorted(dst_sorted,
                                       np.arange(self.num_nodes + 1))

    def _sample_in_neighbors(self, frontier: np.ndarray, f: int,
                             rng: np.random.Generator
                             ) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) global pairs: up to f in-neighbors per frontier node,
        sampled with replacement, fully vectorized."""
        n_edges = self._src_sorted.size
        if n_edges == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        start = self._indptr[frontier]
        cnt = self._indptr[frontier + 1] - start
        draw = rng.integers(0, np.iinfo(np.int64).max,
                            size=(frontier.size, f))
        idx = draw % np.maximum(cnt, 1)[:, None]
        # zero-in-degree frontier nodes are dropped by `keep` below, but
        # their start offset can sit at E (all edge dsts < node id), so
        # the gather index must be clamped BEFORE it is dereferenced
        gather = np.minimum(start[:, None] + idx, n_edges - 1)
        src = self._src_sorted[gather]                        # (k, f)
        dst = np.broadcast_to(frontier[:, None], src.shape)
        keep = np.broadcast_to((cnt > 0)[:, None], src.shape)
        return src[keep], dst[keep]

    def sample(self, step: int) -> SubgraphBatch:
        """Deterministic batch for one step (resume-safe)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step)]))
        replace = self.seed_ids.size < self.batch_nodes
        seeds = rng.choice(self.seed_ids, size=self.batch_nodes,
                           replace=replace)
        # always dedupe: a duplicated seed would own a second local slot
        # with NO edges (the relabel lookup maps the global id to one
        # slot), silently training the loss on un-aggregated logits
        seeds = np.unique(seeds)
        frontier = seeds
        srcs, dsts = [], []
        for f in self.fanout:
            s, d = self._sample_in_neighbors(frontier, f, rng)
            srcs.append(s)
            dsts.append(d)
            frontier = np.unique(s)
        src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)

        # local id space: seeds first (so seed_mask is a prefix), then the
        # sampled closure, cropped to the budget (drop non-seed overflow —
        # a RANDOM subset: setdiff1d is sorted, so a prefix crop would
        # exclude high-id neighbors from every batch)
        rest = np.setdiff1d(np.concatenate([src, dst]), seeds)
        if seeds.size + rest.size > self.budget:
            rest = rest[rng.permutation(rest.size)
                        [: self.budget - seeds.size]]
        nodes = np.concatenate([seeds, rest])
        num_real = nodes.size

        lookup = np.full(self.num_nodes, -1, dtype=np.int64)
        lookup[nodes] = np.arange(num_real)
        ls, ld = lookup[src], lookup[dst]
        keep = (ls >= 0) & (ld >= 0)
        e_local = np.stack([ls[keep], ld[keep]], axis=1)
        if e_local.size:
            e_local = np.unique(e_local, axis=0)
        if e_local.shape[0] > self.edge_cap:
            # cannot happen with the sum(fanout) cap above; if a future
            # cap change reintroduces it, drop a random subset (a sorted
            # prefix crop would systematically silence high-id sources)
            import warnings
            warnings.warn(
                f"sampled subgraph exceeded edge_cap "
                f"({e_local.shape[0]} > {self.edge_cap}); dropping a "
                f"random subset")
            e_local = e_local[rng.permutation(e_local.shape[0])
                              [: self.edge_cap]]

        pad = self.budget - num_real
        nodes_padded = np.concatenate(
            [nodes, np.zeros(pad, np.int64)]) if pad else nodes
        node_valid = np.arange(self.budget) < num_real
        seed_mask = np.arange(self.budget) < seeds.size
        return SubgraphBatch(nodes=nodes_padded, node_valid=node_valid,
                             seed_mask=seed_mask, edges=e_local,
                             num_real=num_real)
