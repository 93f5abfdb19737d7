"""Graph datasets matching the paper's Table II profiles.

The container is offline, so we generate synthetic graphs with the exact
node/edge/feature-dimension counts of Cora, Citeseer and Pubmed (Table II)
using a preferential-attachment degree profile (citation networks are
power-law). Features are dense random vectors; labels are uniform over the
standard class counts. All generation is deterministic per seed, and the
arrays are bitwise equal to ``repro.graphs.datasets.make_dataset``'s for
the same (name, seed, scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphProfile:
    name: str
    num_nodes: int
    num_edges: int
    feature_dim: int
    num_classes: int


# Paper Table II: the evaluation set every paper-table benchmark sweeps.
TABLE2_DATASETS: dict[str, GraphProfile] = {
    "cora": GraphProfile("cora", 2708, 10556, 1433, 7),
    "citeseer": GraphProfile("citeseer", 3327, 9104, 3703, 6),
    "pubmed": GraphProfile("pubmed", 19717, 88648, 500, 3),
}

# Large-graph regime (§VI scaling discussion): a Reddit-scale profile
# (232,965 posts / ~114.6M directed edges / 602 features / 41 classes),
# kept out of TABLE2_DATASETS. The performance model reads its profile;
# make_dataset cannot generate it yet (see _LARGE_GRAPH_EDGES).
LARGE_DATASETS: dict[str, GraphProfile] = {
    "reddit": GraphProfile("reddit", 232965, 114615892, 602, 41),
}

DATASETS: dict[str, GraphProfile] = {**TABLE2_DATASETS, **LARGE_DATASETS}

# Above this many target edges the reference package switches to a
# vectorized power-law sampler that this package does not carry yet.
_LARGE_GRAPH_EDGES = 1_000_000


@dataclasses.dataclass
class GraphData:
    profile: GraphProfile
    edges: np.ndarray      # (E, 2) int64 (src, dst), both directions present
    features: np.ndarray   # (N, F) float32
    labels: np.ndarray     # (N,) int32
    train_mask: np.ndarray # (N,) bool
    # monotonic mutation generation, bumped by graphs.delta
    # .apply_to_graph_data; folded into compile fingerprints and
    # GraphStore keys so a stale build is never served
    version: int = 0


def _preferential_attachment_edges(n: int, e_target: int, rng: np.random.Generator) -> np.ndarray:
    """Undirected preferential-attachment edge list with ~e_target/2 unique
    undirected edges (returned with both directions, ≈ e_target directed)."""
    # edges added per new node; clamped so the m seed nodes (and every
    # sampled id) stay inside [0, n) even for very dense scaled profiles
    m = max(1, min(e_target // (2 * n), n - 1))
    extra = e_target // 2 - m * (n - m)
    # classic BA via repeated-node sampling
    targets = list(range(m))
    repeated: list[int] = list(range(m))
    edges = []
    for v in range(m, n):
        for t in set(targets):
            edges.append((v, t))
            repeated.extend([v, t])
        # next targets: preferential sample
        idx = rng.integers(0, len(repeated), size=m)
        targets = [repeated[i] for i in idx]
    # top up to the target count with preferential random pairs
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
    # dedupe undirected, then emit both directions
    und = np.unique(np.sort(e, axis=1), axis=0)
    return np.concatenate([und, und[:, ::-1]], axis=0)


def make_dataset(name: str, *, seed: int = 0, scale: float = 1.0) -> GraphData:
    """Generate a synthetic dataset with the given Table-II profile.

    ``scale`` multiplies node/edge counts; feature_dim is kept.
    """
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: "
                       f"{sorted(DATASETS)}")
    # a copy: a streaming delta grows the GraphData's profile in place
    # (graphs.delta.apply_to_graph_data), which must not reach DATASETS
    prof = dataclasses.replace(DATASETS[name])
    if scale != 1.0:
        prof = GraphProfile(
            f"{name}-x{scale:g}",
            int(prof.num_nodes * scale),
            int(prof.num_edges * scale),
            prof.feature_dim,
            prof.num_classes,
        )
    if prof.num_edges > _LARGE_GRAPH_EDGES:
        raise NotImplementedError(
            f"{prof.name}: {prof.num_edges} edges needs the power-law "
            f"generator, which is not ported yet")
    rng = np.random.default_rng(seed)
    edges = _preferential_attachment_edges(prof.num_nodes, prof.num_edges, rng)
    feats = rng.standard_normal((prof.num_nodes, prof.feature_dim), dtype=np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    labels = rng.integers(0, prof.num_classes, size=prof.num_nodes).astype(np.int32)
    # plant weak class signal so training has something to learn
    planted = rng.standard_normal((prof.num_classes, prof.feature_dim), dtype=np.float32)
    feats += 0.5 * planted[labels] / np.sqrt(prof.feature_dim)
    train_mask = rng.random(prof.num_nodes) < 0.6
    return GraphData(prof, edges, feats, labels, train_mask)
