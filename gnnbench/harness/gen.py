"""The benchmark's input graphs: one graph a configuration, drawn once
from :data:`GRAPH_SEED`, its nodes put in an order drawn from the run's
seed (:func:`relabel`), so that every seed gives the program the same
work in another order.

The generator is a frozen copy of the program's
``graphs/datasets.make_dataset``: it draws from a
``numpy.random.Generator`` in the same order, so it gives bitwise the
same arrays for one seed (``gnnbench/tests/test_gnnbench_gen.py``), and
it stays as it is when the program's generator changes. It returns plain
numpy arrays; the driver wraps them in the program's types.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the profiles the generators know (graphs/datasets.py, paper Table II and
# the GraphSAGE Reddit graph): name -> (nodes, directed edges, features,
# classes)
PROFILES = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9104, 3703, 6),
    "pubmed": (19717, 88648, 500, 3),
    "reddit": (232965, 114615892, 602, 41),
}

# the seed of every configuration's graph; a run's --seed draws the order
# of its nodes and its weights. A graph drawn from the run's seed would
# change the work with the seed: Pubmed's kernels take 0.079-0.088 ms a
# refresh as the largest row's degree goes from 232 to 609 over six seeds.
GRAPH_SEED = 0

# above this many target edges the edges come from the vectorized
# power-law sampler instead of the preferential-attachment loop
LARGE_GRAPH_EDGES = 1_000_000


@dataclasses.dataclass
class Graph:
    """A generated graph: (E, 2) int64 (src, dst) edges with both
    directions present, (N, F) float32 features, (N,) int32 labels."""

    name: str
    num_nodes: int
    num_edges: int
    feature_dim: int
    num_classes: int
    edges: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    train_mask: np.ndarray


def _preferential_attachment_edges(n: int, e_target: int,
                                   rng: np.random.Generator) -> np.ndarray:
    m = max(1, min(e_target // (2 * n), n - 1))
    extra = e_target // 2 - m * (n - m)
    targets = list(range(m))
    repeated: list[int] = list(range(m))
    edges = []
    for v in range(m, n):
        for t in set(targets):
            edges.append((v, t))
            repeated.extend([v, t])
        idx = rng.integers(0, len(repeated), size=m)
        targets = [repeated[i] for i in idx]
    repeated_arr = np.array(repeated)
    while extra > 0:
        k = min(extra, 4096)
        a = repeated_arr[rng.integers(0, len(repeated_arr), size=k)]
        b = rng.integers(0, n, size=k)
        mask = a != b
        for u, v in zip(a[mask], b[mask]):
            edges.append((int(u), int(v)))
        extra -= int(mask.sum())
    e = np.array(edges, dtype=np.int64)
    und = np.unique(np.sort(e, axis=1), axis=0)
    return np.concatenate([und, und[:, ::-1]], axis=0)


def unique_sorted(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D array, by a sort and a neighbour compare:
    the same sorted values. NumPy 2.3's ``np.unique`` takes 13 s for the
    8.4 M keys of reddit x0.1 on the H100's host, its sort 0.17 s."""
    s = np.sort(keys)
    keep = np.empty(len(s), dtype=bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _powerlaw_edges(n: int, e_target: int,
                    rng: np.random.Generator) -> np.ndarray:
    want = e_target // 2
    ranks = np.arange(n, dtype=np.float64)
    w = 1.0 / (ranks + 1.0) ** 0.8
    w /= w.sum()
    perm = rng.permutation(n)
    keys = np.empty(0, dtype=np.int64)
    it = stalls = 0
    while len(keys) < want and stalls < 3:
        short = want - len(keys)
        k = int(min(max(short * 1.4, 1 << 14), 1 << 23))
        if it < 4:
            src = perm[rng.choice(n, size=k, p=w)]
        else:
            src = rng.integers(0, n, size=k)
        dst = rng.integers(0, n, size=k)
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        new = unique_sorted(lo[src != dst] * n + hi[src != dst])
        fresh = new[~np.isin(new, keys, assume_unique=True)]
        stalls = stalls + 1 if len(fresh) < max(k // 100, 1) else 0
        keys = np.concatenate([keys, fresh])
        keys.sort()
        it += 1
    if len(keys) < want:
        raise ValueError(f"power-law generator saturated at {len(keys)} of "
                         f"{want} undirected edges for n={n}")
    if len(keys) > want:
        keys = keys[rng.permutation(len(keys))[:want]]
    und = np.stack([keys // n, keys % n], axis=1)
    return np.concatenate([und, und[:, ::-1]], axis=0)


def make_graph(name: str, *, seed: int, scale: float = 1.0) -> Graph:
    """The graph ``make_dataset(name, seed=seed, scale=scale)`` gives."""
    nodes, edges_target, feat_dim, classes = PROFILES[name]
    label = name
    if scale != 1.0:
        label = f"{name}-x{scale:g}"
        nodes, edges_target = int(nodes * scale), int(edges_target * scale)
    rng = np.random.default_rng(seed)
    if edges_target > LARGE_GRAPH_EDGES:
        edges = _powerlaw_edges(nodes, edges_target, rng)
    else:
        edges = _preferential_attachment_edges(nodes, edges_target, rng)
    feats = rng.standard_normal((nodes, feat_dim), dtype=np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    labels = rng.integers(0, classes, size=nodes).astype(np.int32)
    planted = rng.standard_normal((classes, feat_dim), dtype=np.float32)
    feats += 0.5 * planted[labels] / np.sqrt(feat_dim)
    train_mask = rng.random(nodes) < 0.6
    return Graph(label, nodes, edges_target, feat_dim, classes, edges, feats,
                 labels, train_mask)


def relabel(g: Graph, perm: np.ndarray) -> Graph:
    """``g`` with node i renamed ``perm[i]``: the same edges, features,
    labels and training mask, rows in another order."""
    def moved(rows: np.ndarray) -> np.ndarray:
        out = np.empty_like(rows)
        out[perm] = rows
        return out

    return dataclasses.replace(
        g, edges=perm[g.edges], features=moved(g.features),
        labels=moved(g.labels), train_mask=moved(g.train_mask))


def pair_keys(edges: np.ndarray) -> np.ndarray:
    """One int64 key per directed (src, dst) pair: (src << 32) | dst."""
    e = np.asarray(edges, dtype=np.int64)
    return (e[:, 0] << np.int64(32)) | e[:, 1]
