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
# (232,965 posts / ~114.6M directed edges / 602 features / 41 classes).
# Kept out of TABLE2_DATASETS so paper-table averages stay comparable to
# the paper's three-dataset numbers.
LARGE_DATASETS: dict[str, GraphProfile] = {
    "reddit": GraphProfile("reddit", 232965, 114615892, 602, 41),
}

# Everything loadable by name via make_dataset/load.
DATASETS: dict[str, GraphProfile] = {**TABLE2_DATASETS, **LARGE_DATASETS}

# Above this many target edges the O(N·m) pure-python BA loop is too slow;
# switch to the vectorized power-law sampler.
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

    @property
    def size_mb(self) -> float:
        return self.features.nbytes / 2 ** 20


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


def _powerlaw_edges(n: int, e_target: int, rng: np.random.Generator) -> np.ndarray:
    """Vectorized power-law edge sampler for large (reddit-scale) graphs.

    The O(N·m) python BA loop above is fine for citation-network sizes but
    takes minutes at 10⁸ edges. Here sources are drawn from a Zipf-like
    rank distribution (heavy-tailed out-degree, matching social graphs)
    and destinations uniformly; duplicates are deduped and the undirected
    edge set emitted in both directions, like the BA path.
    """
    want = e_target // 2
    # rank weights ~ 1/(rank+1)^0.8: heavy tail without a single mega-hub
    ranks = np.arange(n, dtype=np.float64)
    w = 1.0 / (ranks + 1.0) ** 0.8
    w /= w.sum()
    perm = rng.permutation(n)          # decouple node id from degree rank
    # dedupe on scalar keys u*n+v (1-D unique is far cheaper than 2-D) and
    # resample until the unique undirected target is hit (the heavy tail
    # makes hub pairs collide often); uniform top-up after a few rounds
    # guarantees convergence even for very dense scaled profiles
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
        new = np.unique(lo[src != dst] * n + hi[src != dst])
        fresh = new[~np.isin(new, keys, assume_unique=True)]
        # a near-saturated pair space yields ever-fewer fresh keys; three
        # low-yield rounds in a row means the target is out of reach
        stalls = stalls + 1 if len(fresh) < max(k // 100, 1) else 0
        keys = np.concatenate([keys, fresh])
        keys.sort()
        it += 1
    if len(keys) < want:
        import warnings
        warnings.warn(
            f"power-law generator saturated at {len(keys)} of {want} unique "
            f"undirected edges for n={n}; graph will be short of the profile")
    if len(keys) > want:
        # random subsample: the key list is sorted, so a prefix slice would
        # systematically disconnect the high-id node range
        keys = keys[rng.permutation(len(keys))[:want]]
    und = np.stack([keys // n, keys % n], axis=1)
    return np.concatenate([und, und[:, ::-1]], axis=0)


def make_dataset(name: str, *, seed: int = 0, scale: float = 1.0) -> GraphData:
    """Generate a synthetic dataset with the given Table-II profile.

    ``scale`` multiplies node/edge counts; feature_dim is kept. Above
    ``_LARGE_GRAPH_EDGES`` target edges (reddit) the edges come from the
    vectorized power-law sampler.
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
    rng = np.random.default_rng(seed)
    if prof.num_edges > _LARGE_GRAPH_EDGES:
        edges = _powerlaw_edges(prof.num_nodes, prof.num_edges, rng)
    else:
        edges = _preferential_attachment_edges(prof.num_nodes, prof.num_edges, rng)
    feats = rng.standard_normal((prof.num_nodes, prof.feature_dim), dtype=np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    labels = rng.integers(0, prof.num_classes, size=prof.num_nodes).astype(np.int32)
    # plant weak class signal so training has something to learn
    planted = rng.standard_normal((prof.num_classes, prof.feature_dim), dtype=np.float32)
    feats += 0.5 * planted[labels] / np.sqrt(prof.feature_dim)
    train_mask = rng.random(prof.num_nodes) < 0.6
    return GraphData(prof, edges, feats, labels, train_mask)


def load(name: str, seed: int = 0, *, scale: float = 1.0
         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-call loader: ``features, labels, edges = load("cora", seed)``.

    Thin convenience over :func:`make_dataset` for callers that only need
    the three arrays. ``scale`` shrinks node/edge counts proportionally —
    the reddit profile at scale=1.0 generates ~115M directed edges, so
    scale it down (``load("reddit", scale=0.1)``: 23,296 nodes, ~11.5M
    edges).
    """
    ds = make_dataset(name, seed=seed, scale=scale)
    return ds.features, ds.labels, ds.edges
