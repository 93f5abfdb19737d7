"""Mutation workload generation for streaming runs.

The port of ``repro.stream.workload`` (host numpy): it draws from the
caller's generator in the reference's order, so one seed gives the same
deltas in both packages (tests/test_torch_stream.py).

:func:`random_delta` draws one plausible :class:`GraphDelta` against the
CURRENT state of a graph: edge churn (delete existing pairs / insert new
ones, including delete-then-reinsert collisions) and optional node
arrivals with features sampled near existing nodes. Deterministic under
the caller's ``numpy.random.Generator``: ``launch/stream.py`` and
``chip_smoke.py`` draw requests and deltas from one seeded stream.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.datasets import GraphData
from repro_torch.graphs.delta import GraphDelta, _pair_keys


def random_delta(data: GraphData, rng: np.random.Generator, *,
                 edge_ops: int = 8, p_delete: float = 0.5,
                 p_node: float = 0.0, max_new_nodes: int = 1) -> GraphDelta:
    """One random delta against ``data``'s current edges.

    ``edge_ops`` edge operations split ~``p_delete`` deletes / rest
    inserts; with probability ``p_node`` up to ``max_new_nodes`` nodes
    arrive (features = a perturbed copy of a random existing node's,
    labels copied from it so fine-tuning has supervision). Inserted
    edges avoid currently-present pairs (deletes target exactly one
    existing row set each), but a pair deleted by THIS delta may be
    reinserted by it — apply order is delete-then-append.
    """
    edges = np.asarray(data.edges, dtype=np.int64)
    num_nodes = data.profile.num_nodes
    n_del = int(rng.binomial(edge_ops, p_delete))
    n_add = edge_ops - n_del

    del_edges = None
    if n_del and edges.shape[0]:
        idx = rng.choice(edges.shape[0], size=min(n_del, edges.shape[0]),
                         replace=False)
        # dedupe by pair: one delete op removes every row of its pair
        _, first = np.unique(_pair_keys(edges[idx]), return_index=True)
        del_edges = edges[idx[np.sort(first)]]

    add_nodes = 0
    add_features = add_labels = None
    if p_node > 0 and rng.random() < p_node:
        add_nodes = int(rng.integers(1, max_new_nodes + 1))
        like = rng.integers(0, num_nodes, size=add_nodes)
        if data.features is not None:
            add_features = (data.features[like]
                            + rng.normal(0, 0.01, (add_nodes,
                                                   data.features.shape[1]))
                            .astype(np.float32))
        if data.labels is not None:
            add_labels = data.labels[like]

    add_edges = None
    if n_add:
        total = num_nodes + add_nodes
        have = set(_pair_keys(edges).tolist())
        rows = []
        for _ in range(n_add * 4):          # rejection-sample fresh pairs
            if len(rows) >= n_add:
                break
            u, v = int(rng.integers(0, total)), int(rng.integers(0, total))
            if u == v or ((u << 32) | v) in have:
                continue
            have.add((u << 32) | v)
            rows.append((u, v))
        # new nodes must not arrive isolated: wire each to a random
        # existing node so sampling/invalidation reach them
        for k in range(add_nodes):
            u = num_nodes + k
            v = int(rng.integers(0, num_nodes))
            if ((u << 32) | v) not in have:
                have.add((u << 32) | v)
                rows.append((u, v))
        if rows:
            add_edges = np.asarray(rows, dtype=np.int64)

    return GraphDelta(add_edges=add_edges, del_edges=del_edges,
                      add_nodes=add_nodes, add_features=add_features,
                      add_labels=add_labels)
