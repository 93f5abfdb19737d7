"""Graph mutation log: `GraphDelta` and its canonical application.

The port of ``repro.graphs.delta`` (host numpy, no torch), held bitwise
to it by tests/test_torch_stream.py.

A :class:`GraphDelta` records edge/node inserts and deletes against a live
graph. Application is defined against a **canonical edge list** so every
consumer — the in-place :class:`~repro_torch.graphs.datasets.GraphData` update,
the incremental shard patcher (:mod:`repro_torch.graphs.patch`) and a
from-scratch rebuild — produces bitwise-identical tensors:

  * deletions remove *all* rows matching each (src, dst) pair, keeping the
    relative order of the survivors (stable mask, no re-sort);
  * node deletions are expressed as edge deletions: every incident row is
    removed, but the node keeps its id slot (no renumbering — live
    requests hold global ids). Architectures with self loops still
    aggregate the isolated node's own features, exactly as a rebuild of
    the pruned edge list would;
  * insertions append, edges after nodes: new node ids extend the id
    space first, then new edge rows (which may reference them) go at the
    end of the list.

The second half of this module is the invalidation math: which node rows
of a cached full-graph softmax a delta can actually change.
:func:`seed_nodes` gives the 1-layer-affected set (normalization-aware —
under `gcn` a degree change reweights every edge out of the touched
source), and :func:`affected_nodes` closes it over (L-1) out-hops for an
L-layer model. Serving drops only those rows (*targeted* invalidation)
instead of flushing the cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ids are < 2^31 (int32 device indices), so (src << 32) | dst is a unique
# int64 key per directed pair — the match unit for deletions
_KEY_SHIFT = np.int64(32)


def _pair_keys(edges: np.ndarray) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64)
    return (e[:, 0] << _KEY_SHIFT) | e[:, 1]


def _as_edge_array(edges) -> np.ndarray:
    if edges is None:
        return np.empty((0, 2), dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64)
    if e.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    e = e.reshape(-1, 2)
    return e


@dataclasses.dataclass
class GraphDelta:
    """One batch of graph mutations (applied atomically).

    Attributes:
      add_edges: (K, 2) int64 (src, dst) rows to append. May reference the
        ``add_nodes`` new ids.
      del_edges: (K, 2) int64 pairs to remove; every row matching a pair
        is removed. Deleting a pair with no matching row is an error
        (caught before anything is mutated).
      add_nodes: number of new nodes appended to the id space.
      add_features: (add_nodes, F) float32 features for the new nodes
        (required by featureful consumers when add_nodes > 0).
      add_labels: (add_nodes,) int labels for the new nodes (default -1 =
        unlabeled; excluded from training masks).
      del_nodes: (K,) node ids to *isolate* — all incident edges removed,
        id slot retained (no renumbering).
    """

    add_edges: np.ndarray | None = None
    del_edges: np.ndarray | None = None
    add_nodes: int = 0
    add_features: np.ndarray | None = None
    add_labels: np.ndarray | None = None
    del_nodes: np.ndarray | None = None

    def __post_init__(self):
        self.add_edges = _as_edge_array(self.add_edges)
        self.del_edges = _as_edge_array(self.del_edges)
        self.add_nodes = int(self.add_nodes)
        self.del_nodes = (np.empty(0, dtype=np.int64) if self.del_nodes
                          is None else np.unique(np.asarray(self.del_nodes,
                                                            dtype=np.int64)))
        if self.add_nodes < 0:
            raise ValueError(f"add_nodes must be >= 0, got {self.add_nodes}")
        if self.add_features is not None:
            self.add_features = np.asarray(self.add_features,
                                           dtype=np.float32)
            if self.add_features.shape[0] != self.add_nodes:
                raise ValueError(
                    f"add_features covers {self.add_features.shape[0]} "
                    f"nodes, add_nodes is {self.add_nodes}")
        if self.add_labels is not None:
            self.add_labels = np.asarray(self.add_labels, dtype=np.int32)
            if self.add_labels.shape[0] != self.add_nodes:
                raise ValueError(
                    f"add_labels covers {self.add_labels.shape[0]} nodes, "
                    f"add_nodes is {self.add_nodes}")

    @property
    def num_ops(self) -> int:
        return (self.add_edges.shape[0] + self.del_edges.shape[0]
                + self.add_nodes + self.del_nodes.size)

    def summary(self) -> str:
        return (f"GraphDelta(+{self.add_edges.shape[0]}e "
                f"-{self.del_edges.shape[0]}e +{self.add_nodes}n "
                f"-{self.del_nodes.size}n)")


def removed_edge_mask(edges: np.ndarray, delta: GraphDelta) -> np.ndarray:
    """Boolean mask over ``edges`` rows the delta removes (explicit
    del_edges pairs plus every row incident to a del_nodes id). Raises if
    a del_edges pair matches no row, or a del/add id is out of range."""
    edges = np.asarray(edges, dtype=np.int64)
    mask = np.zeros(edges.shape[0], dtype=bool)
    if delta.del_edges.shape[0]:
        keys = _pair_keys(edges)
        del_keys = np.unique(_pair_keys(delta.del_edges))
        hit = np.isin(keys, del_keys)
        # every requested pair must match at least one row
        present = np.isin(del_keys, keys[hit])
        if not present.all():
            bad = del_keys[~present][0]
            raise ValueError(
                f"cannot delete edge ({int(bad >> _KEY_SHIFT)}, "
                f"{int(bad & np.int64(0xFFFFFFFF))}): no such edge")
        mask |= hit
    if delta.del_nodes.size:
        mask |= np.isin(edges[:, 0], delta.del_nodes)
        mask |= np.isin(edges[:, 1], delta.del_nodes)
    return mask


def apply_to_edge_list(edges: np.ndarray, num_nodes: int,
                       delta: GraphDelta) -> tuple[np.ndarray, int]:
    """Canonical application: ``(new_edges, new_num_nodes)``.

    Validates everything before returning (the inputs are never mutated),
    so a raising delta leaves the caller's arrays untouched.
    """
    edges = np.asarray(edges, dtype=np.int64)
    new_num = num_nodes + delta.add_nodes
    for name, ids in (("del_nodes", delta.del_nodes),
                      ("del_edges", delta.del_edges.reshape(-1)),
                      ("add_edges", delta.add_edges.reshape(-1))):
        bound = num_nodes if name.startswith("del") else new_num
        if ids.size and (ids.min() < 0 or ids.max() >= bound):
            raise ValueError(
                f"{name} ids must be in [0, {bound}); got range "
                f"[{ids.min()}, {ids.max()}]")
    mask = removed_edge_mask(edges, delta)
    kept = edges[~mask]
    if delta.add_edges.shape[0]:
        kept = np.concatenate([kept, delta.add_edges], axis=0)
    return np.ascontiguousarray(kept), new_num


def apply_to_graph_data(data, delta: GraphDelta) -> None:
    """Mutate a :class:`~repro_torch.graphs.datasets.GraphData` in place:
    edges, features/labels/train_mask extension for new nodes, profile
    counters, and the monotonic ``version``. Validation happens before
    the first field is touched."""
    new_edges, new_num = apply_to_edge_list(
        data.edges, data.profile.num_nodes, delta)
    k = delta.add_nodes
    if k:
        if data.features is not None:
            if delta.add_features is None:
                raise ValueError(
                    f"graph has features; a delta adding {k} nodes must "
                    f"carry add_features")
            if delta.add_features.shape[1] != data.features.shape[1]:
                raise ValueError(
                    f"add_features dim {delta.add_features.shape[1]} != "
                    f"graph feature dim {data.features.shape[1]}")
            data.features = np.concatenate(
                [data.features, delta.add_features], axis=0)
        if data.labels is not None:
            lab = (delta.add_labels if delta.add_labels is not None
                   else np.full(k, -1, dtype=np.int32))
            data.labels = np.concatenate([data.labels, lab])
        if data.train_mask is not None:
            # labeled new nodes join the train set; unlabeled (-1) don't
            new_mask = (delta.add_labels >= 0 if delta.add_labels
                        is not None else np.zeros(k, dtype=bool))
            data.train_mask = np.concatenate(
                [data.train_mask, np.asarray(new_mask, dtype=bool)])
    data.edges = new_edges
    data.profile.num_nodes = new_num
    data.profile.num_edges = int(new_edges.shape[0])
    data.version = getattr(data, "version", 0) + 1


# --------------------------------------------------------------------------
# invalidation math
# --------------------------------------------------------------------------

def touched_nodes(delta: GraphDelta, edges_before: np.ndarray,
                  num_nodes_before: int) -> np.ndarray:
    """Every node id a delta directly touches (endpoints of changed edges,
    deleted/inserted nodes) — the seed set the stream trainer fine-tunes
    around, independent of any normalization."""
    parts = [delta.add_edges.reshape(-1), delta.del_edges.reshape(-1),
             delta.del_nodes,
             np.arange(num_nodes_before,
                       num_nodes_before + delta.add_nodes, dtype=np.int64)]
    if delta.del_nodes.size:
        e = np.asarray(edges_before, dtype=np.int64)
        inc = (np.isin(e[:, 0], delta.del_nodes)
               | np.isin(e[:, 1], delta.del_nodes))
        parts.append(e[inc].reshape(-1))
    out = np.unique(np.concatenate(parts)) if parts else \
        np.empty(0, np.int64)
    return out


def seed_nodes(delta: GraphDelta, edges_before: np.ndarray,
               edges_after: np.ndarray, num_nodes_before: int,
               normalize: str) -> np.ndarray:
    """Nodes whose layer-1 aggregation output a delta changes.

    For every changed (inserted or removed) edge (u, v):

      * the destination v aggregates a different neighbor set — always
        affected;
      * under ``gcn`` (weight 1/sqrt(deg_out(u)·deg_in(v))) the source
        degree changed, so every *surviving* edge u -> x is reweighted:
        u itself (self loop) and its whole out-neighborhood join the set.
        (`mean` weights depend on deg_in(dst) only, which the v-rule
        already covers; `sum`/`max` weights are constant.)

    New node ids are included (their rows did not exist before).
    """
    edges_before = np.asarray(edges_before, dtype=np.int64)
    edges_after = np.asarray(edges_after, dtype=np.int64)
    removed = delta.del_edges
    if delta.del_nodes.size:
        inc = (np.isin(edges_before[:, 0], delta.del_nodes)
               | np.isin(edges_before[:, 1], delta.del_nodes))
        removed = np.concatenate([removed, edges_before[inc]], axis=0)
    changed = np.concatenate([delta.add_edges, removed], axis=0)
    parts = [changed[:, 1],
             np.arange(num_nodes_before,
                       num_nodes_before + delta.add_nodes, dtype=np.int64)]
    if normalize == "gcn" and changed.shape[0]:
        srcs = np.unique(changed[:, 0])
        parts.append(srcs)               # their self loops reweight
        out_hit = np.isin(edges_after[:, 0], srcs)
        parts.append(edges_after[out_hit, 1])
        parts.append(delta.del_nodes)    # isolated: self loop reweights
    return np.unique(np.concatenate(parts))


def affected_nodes(edges_after: np.ndarray, seeds: np.ndarray,
                   hops: int, num_nodes: int) -> np.ndarray:
    """Close ``seeds`` over ``hops`` out-neighbor hops of the post-delta
    graph — the rows of an (hops+1)-layer model's output a delta can
    change. Vectorized frontier expansion; self-retention is implicit
    (a seed stays affected)."""
    e = np.asarray(edges_after, dtype=np.int64)
    mask = np.zeros(num_nodes, dtype=bool)
    seeds = np.asarray(seeds, dtype=np.int64)
    mask[seeds[seeds < num_nodes]] = True
    for _ in range(max(int(hops), 0)):
        hit = mask[e[:, 0]]
        before = mask.sum()
        mask[e[hit, 1]] = True
        if mask.sum() == before:     # fixed point: stop early
            break
    return np.flatnonzero(mask)
