"""Distributed graph partitioning: map the 2-D shard grid onto the mesh.

The port of ``repro.graphs.partition`` (host numpy, held bitwise to the
reference by ``tests/test_torch_dist_partition.py``). Cluster-scale
version of the paper's parallelism: shard-grid ROWS (destination ranges)
ride the ``data`` axis — each data group owns the aggregation of its
destination nodes (inter-node parallelism); the FEATURE axis rides
``model`` — the distributed generalization of dimension-blocking
(intra-node parallelism). The plan below computes which source features
each data group must receive per step: exactly the paper's Table-I
traffic, with DRAM reads become cross-device transfers.

Two placement methods:

  * ``method="contiguous"`` — contiguous dst-shard row ranges per data
    group (``pad=True`` gives the equal row groups the SPMD program
    needs). Zero bookkeeping, but on power-law graphs ~half the edges
    cross groups and per-group edge work is badly skewed.
  * ``method="fennel"`` — a Fennel-style streaming partitioner at
    **vertex** granularity (GNNIE's load balancing + the classic Fennel
    objective): vertices are greedily placed on the data group holding
    most of their already-placed neighbors minus a load penalty on that
    group's accumulated *edge* work (not row count), then refined with
    local-move sweeps. The plan emits a feature-ROW permutation
    (``perm``/``slot_of``) mapping vertices into per-group slot ranges;
    ``dist/gnn.py::ShardedExecutable`` applies it when building the
    padded row groups and inverts it on output. On top of placement, the
    top-k highest out-degree vertices become replicated **hub** rows:
    their features are broadcast to every data group at layer entry (one
    small all-gather) and their edges are masked out of the per-group
    halo exchange — GNNIE's graph-specific caching, sized by
    ``hub_cache``. If the heuristic ever loses to the contiguous split on
    cross-group edges, the plan falls back to the identity placement (so
    ``fennel`` is never worse than ``contiguous``).

``sg`` may hold numpy arrays (a ``core.sharding.ShardedGraph``) or
device tensors (a ``core.engines.GraphTensors``): the edge lists are
read back to the host once per plan.

``dist/gnn.py`` executes exactly this decomposition on a mesh and
verifies its counted all-gather volume against the plan's models.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    n_data: int                 # data-axis size
    rows_per_group: int         # max dst shard rows any data group owns
    # comm_matrix[g_dst, g_src] = edges whose sources live on g_src and
    # destinations on g_dst (off-diagonal = cross-group transfers). For
    # ``method="fennel"`` hub-sourced edges are EXCLUDED (they are served
    # from the replicated hub cache, not pulled) and counted in
    # ``hub_edges`` instead — the denominator of cross_group_edge_frac
    # still covers every edge.
    comm_matrix: np.ndarray
    # contiguous: dst shard rows owned per group. fennel: vertices placed
    # per group (vertex granularity).
    group_sizes: tuple[int, ...] = ()
    method: str = "contiguous"
    shard_n: int = 0            # nodes per shard row (n); 0 = unknown
    # -- fennel placement (None/0 for contiguous) --------------------------
    # slot -> original flat node id over the PADDED slot space
    # (n_data * rows_per_group * shard_n slots); -1 marks an empty slot
    perm: np.ndarray | None = None
    # original flat node id -> slot (total over the original S*n ids)
    slot_of: np.ndarray | None = None
    node_group: np.ndarray | None = None   # (S*n,) vertex -> data group
    hub_nodes: np.ndarray | None = None    # (k,) original flat ids
    hub_edges: int = 0                     # edges with a hub source
    # per-group send-slot capacities the SPMD program is compiled with
    # (max over groups + slack); the wire models below use these because
    # padded slots ship too
    hub_cap: int = 0
    halo_cap: int = 0
    # (n_data, hub_cap) local send indices (dummy = rows_per_group*shard_n)
    hub_send: np.ndarray | None = None
    halo_send: np.ndarray | None = None
    # (n_data*cap,) global receive slots (dummy = n_data*rows_per_group*n)
    hub_recv: np.ndarray | None = None
    halo_recv: np.ndarray | None = None
    # dst-side edge work per group, INCLUDING hub-sourced edges (the
    # group still aggregates them locally from the cache) — the
    # straggler predictor balance_report reads
    edge_work: tuple[int, ...] = ()
    # unique (dst-group, src-row) cross pulls (group-level dedup of the
    # per-edge count; see transfer_bytes_per_layer)
    dedup_pulls: int | None = None

    # -- analytics ---------------------------------------------------------

    @property
    def total_edges(self) -> float:
        return float(self.comm_matrix.sum()) + float(self.hub_edges)

    @property
    def cross_group_edge_frac(self) -> float:
        total = self.total_edges
        if total == 0:
            return 0.0
        off = float(self.comm_matrix.sum() - np.trace(self.comm_matrix))
        return off / total

    @property
    def hub_rows(self) -> int:
        """Replicated hub vertices (0 when hub caching is off)."""
        return 0 if self.hub_nodes is None else int(self.hub_nodes.size)

    @property
    def edge_imbalance(self) -> float:
        """max/mean dst-side edge work over NON-EMPTY groups (groups that
        own no rows/vertices are excluded — they cannot straggle). 1.0
        for edgeless graphs: nothing to balance, and no division by a
        clamped (or zero) mean silently deflating the ratio."""
        work = np.asarray(self.edge_work if self.edge_work
                          else self.comm_matrix.sum(axis=1), dtype=np.float64)
        if self.group_sizes:
            sizes = np.asarray(self.group_sizes)
            work = work[sizes > 0] if (sizes > 0).any() else work[:0]
        else:
            work = work[work > 0]
        if work.size == 0 or work.sum() == 0:
            return 1.0
        return float(work.max() / work.mean())

    def transfer_bytes_per_layer(self, feature_dim: int,
                                 dtype_bytes: int = 2, *,
                                 dedup: bool = True) -> float:
        """Cross-group feature-pull model.

        ``dedup=True`` (default) counts unique (dst-group, src-row)
        pulls: a source row referenced by 50 edges of the same dst group
        ships ONCE. For contiguous plans the dedup is computed from the
        occupancy grid (a (dst-group, src-shard-row) pair pulls at most
        ``min(shard_n, edges)`` rows), for fennel plans it is exact at
        vertex granularity. ``dedup=False`` restores the per-edge count —
        an upper bound that overstates by the group-level multi-edge
        factor."""
        off = float(self.comm_matrix.sum() - np.trace(self.comm_matrix))
        pulls = off
        if dedup and self.dedup_pulls is not None:
            pulls = float(self.dedup_pulls)
        return pulls * feature_dim * dtype_bytes

    def allgather_bytes_per_layer(self, feature_dim: int, shard_n: int,
                                  dtype_bytes: int = 2) -> float:
        """All-gather wire model of what the sharded program in
        dist/gnn.py moves per exchanging layer.

        ``contiguous``: every group broadcasts its ``rows_per_group``
        padded rows to every other group — ``(n_data-1) · n_data ·
        rows_per_group · shard_n · feature_dim`` wire bytes (padded rows
        included: the SPMD program ships them).

        ``fennel``: every group broadcasts only its ``halo_cap`` send
        slots (the non-hub boundary vertices other groups need, padded to
        the compiled capacity) — hub rows ride the separate hub
        broadcast, :meth:`hub_bytes_per_layer`."""
        if self.method == "fennel":
            return float((self.n_data - 1) * self.n_data * self.halo_cap
                         * feature_dim * dtype_bytes)
        total_rows = self.n_data * self.rows_per_group
        return float((self.n_data - 1) * total_rows * shard_n
                     * feature_dim * dtype_bytes)

    def hub_bytes_per_layer(self, feature_dim: int,
                            dtype_bytes: int = 2) -> float:
        """Wire bytes of the per-layer hub broadcast: every group ships
        its ``hub_cap`` replicated-hub slots to every other group."""
        if self.method != "fennel":
            return 0.0
        return float((self.n_data - 1) * self.n_data * self.hub_cap
                     * feature_dim * dtype_bytes)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """A numpy array, or a device tensor read back to the host."""
    return np.asarray(a.cpu()) if hasattr(a, "cpu") else np.asarray(a)


def _global_edge_lists(sg) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) flat vertex ids of every valid edge in the shard grid
    (self-loops included — they are real aggregation work)."""
    S, n = int(sg.S), int(sg.n)
    valid = _host(sg.edge_valid)
    e_src = _host(sg.edge_src)
    e_dst = _host(sg.edge_dst)
    src = (np.arange(S, dtype=np.int64)[None, :, None] * n + e_src)[valid]
    dst = (np.arange(S, dtype=np.int64)[:, None, None] * n + e_dst)[valid]
    return src.astype(np.int64), dst.astype(np.int64)


def _contiguous_dedup_pulls(occ: np.ndarray, group_of: np.ndarray,
                            n_data: int, shard_n: int) -> int:
    """Group-level dedup of the per-edge pull count, from the occupancy
    grid alone: a (dst-group, src-shard-row) pair pulls at most
    ``min(shard_n, edges between them)`` unique rows. Sits between the
    exact unique (dst-group, src-vertex) count and the per-edge count."""
    S = occ.shape[0]
    if S == 0 or shard_n <= 0:
        return 0
    ind = np.zeros((n_data, S))
    ind[group_of, np.arange(S)] = 1.0
    grp_row = ind @ occ                       # (n_data, S) edges per pair
    cross = grp_row * (1.0 - ind)             # zero out own rows
    return int(np.minimum(cross, float(shard_n)).sum())


# --------------------------------------------------------------------------
# contiguous (historical) placement
# --------------------------------------------------------------------------

def _contiguous_plan(sg, n_data: int, *, pad: bool) -> PartitionPlan:
    S = int(sg.S)
    n = int(getattr(sg, "n", 0))
    occ = _host(sg.occupancy).astype(np.float64)
    if pad:
        rows_per_group = _ceil(S, n_data)
        group_of = np.minimum(np.arange(S) // max(rows_per_group, 1),
                              n_data - 1)
    else:
        splits = np.array_split(np.arange(S), n_data)
        group_of = np.empty(S, dtype=np.int64)
        for g, rows in enumerate(splits):
            group_of[rows] = g
        rows_per_group = max((len(rows) for rows in splits), default=0)
    sizes = np.bincount(group_of, minlength=n_data) if S else \
        np.zeros(n_data, dtype=np.int64)
    # comm = G · occ · Gᵀ with G the (n_data, S) group-indicator matrix —
    # one matmul pair instead of the former O(S²) Python double loop
    ind = np.zeros((n_data, S), dtype=np.float64)
    if S:
        ind[group_of, np.arange(S)] = 1.0
    comm = ind @ occ @ ind.T
    return PartitionPlan(
        n_data, int(rows_per_group), comm,
        group_sizes=tuple(int(s) for s in sizes),
        method="contiguous", shard_n=n,
        edge_work=tuple(int(w) for w in comm.sum(axis=1)),
        dedup_pulls=_contiguous_dedup_pulls(occ, group_of, n_data, n)
        if S else 0)


# --------------------------------------------------------------------------
# fennel (vertex-granularity streaming) placement + hub cache
# --------------------------------------------------------------------------

def _fennel_assign(N: int, ptr: np.ndarray, adj: np.ndarray,
                   indeg: np.ndarray, outdeg: np.ndarray, n_data: int,
                   slot_cap: int, total_work: int, *,
                   balance_cap: float, alpha: float, sweeps: int,
                   seed: int, prev: np.ndarray | None,
                   refine_nodes: np.ndarray | None) -> np.ndarray:
    """Greedy streaming placement + local-move refinement over the CSR
    scoring graph (undirected union of non-hub, non-self-loop edges).
    Returns the (N,) vertex -> group assignment (every vertex placed)."""
    avg_work = max(total_work / n_data, 1.0)
    work_cap = balance_cap * avg_work
    group = np.full(N, -1, np.int64)
    gsize = np.zeros(n_data, np.int64)
    gwork = np.zeros(n_data, np.float64)
    deg = indeg + outdeg
    if prev is not None:
        # warm start (streaming mutate): keep the previous placement,
        # re-place only the delta-affected vertices
        group[:] = prev[:N]
        if refine_nodes is not None and len(refine_nodes):
            group[np.asarray(refine_nodes, dtype=np.int64)] = -1
        placed = group >= 0
        gsize += np.bincount(group[placed], minlength=n_data)
        gwork += np.bincount(group[placed], weights=indeg[placed].astype(
            np.float64), minlength=n_data)
    # highest-degree first: hubs and their satellites choose before the
    # long sparse tail fills the remaining capacity
    order = np.argsort(-deg, kind="stable")
    order = order[(deg[order] > 0) & (group[order] < 0)]
    rng = np.random.default_rng(seed)
    tie = rng.random(n_data) * 1e-9
    for v in order:
        nb = adj[ptr[v]:ptr[v + 1]]
        gnb = group[nb]
        aff = np.bincount(gnb[gnb >= 0], minlength=n_data).astype(np.float64)
        # Fennel objective: co-location minus an edge-work load penalty
        score = aff - alpha * (gwork / avg_work) * max(indeg[v], 1) * 0.05
        score[gsize >= slot_cap] = -np.inf
        score[gwork + indeg[v] > work_cap] = -np.inf
        if np.isfinite(score).any():
            g = int(np.argmax(score + tie))
        else:                         # every group at a cap: least-loaded
            g = int(np.argmin(np.where(gsize < slot_cap, gwork, np.inf)))
        group[v] = g
        gsize[g] += 1
        gwork[g] += indeg[v]
    # zero-degree vertices (and grid-padding ids): fill the emptiest slots
    for v in np.where(group < 0)[0]:
        g = int(np.argmin(np.where(gsize < slot_cap, gsize, np.inf)))
        group[v] = g
        gsize[g] += 1
    # local-move refinement: move a vertex iff it strictly gains
    # co-located neighbors and respects both caps
    sweep_order = np.argsort(-deg, kind="stable")
    sweep_order = sweep_order[deg[sweep_order] > 0]
    for _ in range(sweeps):
        moved = 0
        for v in sweep_order:
            g0 = int(group[v])
            nb = adj[ptr[v]:ptr[v + 1]]
            aff = np.bincount(group[nb], minlength=n_data).astype(np.float64)
            cand = aff.copy()
            cand[gsize >= slot_cap] = -np.inf
            cand[gwork + indeg[v] > work_cap] = -np.inf
            g1 = int(np.argmax(cand))
            if g1 != g0 and cand[g1] > aff[g0]:
                group[v] = g1
                gsize[g0] -= 1
                gsize[g1] += 1
                gwork[g0] -= indeg[v]
                gwork[g1] += indeg[v]
                moved += 1
        if not moved:
            break
    return group


def _pad_idx(rows: np.ndarray, cap: int, dummy: int) -> np.ndarray:
    out = np.full(cap, dummy, dtype=np.int32)
    out[:len(rows)] = rows
    return out


def _fennel_plan(sg, n_data: int, *, hub_cache: int, slack: float,
                 alpha: float, sweeps: int, seed: int,
                 prev_groups: np.ndarray | None,
                 refine_nodes: np.ndarray | None,
                 hub_cap: int | None, halo_cap: int | None) -> PartitionPlan:
    S, n = int(sg.S), int(sg.n)
    N = S * n                                  # original flat id space
    rows_per_group = _ceil(S, n_data)
    slot_cap = rows_per_group * n              # vertices a group can hold
    src, dst = _global_edge_lists(sg)
    E = len(src)
    outdeg = np.bincount(src, minlength=N)
    indeg = np.bincount(dst, minlength=N)

    # hub selection: top-k out-degree — the rows whose features the most
    # other destinations consume (GNNIE's cache candidates)
    k = min(int(hub_cache), int((outdeg > 0).sum()))
    hub_nodes = np.argsort(-outdeg, kind="stable")[:k] if k else \
        np.empty(0, dtype=np.int64)
    is_hub = np.zeros(N, dtype=bool)
    is_hub[hub_nodes] = True

    # scoring graph: undirected union of edges whose SOURCE is not a hub
    # (hub-sourced edges are served from the replicated cache — placement
    # cannot make them cheaper) and that are not self-loops (never cross)
    keep = (src != dst) & ~is_hub[src]
    uu = np.concatenate([src[keep], dst[keep]])
    vv = np.concatenate([dst[keep], src[keep]])
    csr_order = np.argsort(uu, kind="stable")
    uu, vv = uu[csr_order], vv[csr_order]
    ptr = np.zeros(N + 1, np.int64)
    np.add.at(ptr, uu + 1, 1)
    ptr = np.cumsum(ptr)

    group = _fennel_assign(
        N, ptr, vv, indeg, outdeg, n_data, slot_cap, E,
        balance_cap=1.20, alpha=alpha, sweeps=sweeps, seed=seed,
        prev=prev_groups, refine_nodes=refine_nodes)

    # never-worse guarantee: if the heuristic lost to the contiguous row
    # split on cross edges (pathological graphs), fall back to the
    # identity placement — hub masking still applies, so the fennel plan's
    # cross fraction stays <= contiguous by construction
    def _cross_edges(grp: np.ndarray) -> int:
        m = ~is_hub[src]
        return int((grp[src[m]] != grp[dst[m]]).sum())

    contiguous_group = np.minimum(np.arange(S) // max(rows_per_group, 1),
                                  n_data - 1)[np.arange(N) // n] \
        if N else np.empty(0, np.int64)
    if N and _cross_edges(group) > int(
            (contiguous_group[src] != contiguous_group[dst]).sum()):
        group = contiguous_group.copy()

    # slots: each group owns the contiguous slot range
    # [g*slot_cap, (g+1)*slot_cap); members fill it in ascending id order
    S_pad_n = n_data * slot_cap
    perm = np.full(S_pad_n, -1, dtype=np.int32)
    slot_of = np.empty(N, dtype=np.int32)
    for g in range(n_data):
        members = np.where(group == g)[0]
        slots = g * slot_cap + np.arange(len(members))
        perm[slots] = members
        slot_of[members] = slots

    # pull matrix over NON-hub-sourced edges (hub rows ride the broadcast)
    m = ~is_hub[src]
    comm = np.zeros((n_data, n_data), dtype=np.float64)
    np.add.at(comm, (group[dst[m]], group[src[m]]), 1.0)
    hub_edges = int(E - m.sum())
    edge_work = np.bincount(group[dst], minlength=n_data)

    # halo per group: unique NON-hub vertices some other group pulls
    cross = m & (group[src] != group[dst])
    halo_sets = [np.unique(src[cross & (group[src] == g)])
                 for g in range(n_data)]
    hub_sets = [hub_nodes[group[hub_nodes] == g] for g in range(n_data)] \
        if k else [np.empty(0, np.int64)] * n_data

    max_halo = max((len(h) for h in halo_sets), default=0)
    max_hub = max((len(h) for h in hub_sets), default=0)
    want_halo = min(int(np.ceil(max_halo * (1.0 + slack))), slot_cap)
    want_hub = int(np.ceil(max_hub * (1.0 + slack)))
    if halo_cap is None:
        halo_cap = max(want_halo, max_halo)
    elif max_halo > halo_cap:
        raise ValueError(
            f"partition capacity exceeded: halo needs {max_halo} send "
            f"slots per group, compiled capacity is {halo_cap} — "
            f"recompile required")
    if hub_cap is None:
        hub_cap = max(want_hub, max_hub)
    elif max_hub > hub_cap:
        raise ValueError(
            f"partition capacity exceeded: hubs need {max_hub} send "
            f"slots per group, compiled capacity is {hub_cap} — "
            f"recompile required")

    loc_dummy, glob_dummy = slot_cap, S_pad_n
    hub_send = np.stack([_pad_idx(slot_of[h] - g * slot_cap, hub_cap,
                                  loc_dummy)
                         for g, h in enumerate(hub_sets)]) \
        if hub_cap else np.zeros((n_data, 0), np.int32)
    halo_send = np.stack([_pad_idx(slot_of[h] - g * slot_cap, halo_cap,
                                   loc_dummy)
                          for g, h in enumerate(halo_sets)]) \
        if halo_cap else np.zeros((n_data, 0), np.int32)
    hub_recv = np.concatenate([_pad_idx(slot_of[h], hub_cap, glob_dummy)
                               for h in hub_sets]) \
        if hub_cap else np.zeros(0, np.int32)
    halo_recv = np.concatenate([_pad_idx(slot_of[h], halo_cap, glob_dummy)
                                for h in halo_sets]) \
        if halo_cap else np.zeros(0, np.int32)

    # exact unique (dst-group, src-row) pulls (vertex granularity)
    dedup = int(np.unique(group[dst[cross]].astype(np.int64) * N
                          + src[cross]).size) if cross.any() else 0

    sizes = np.bincount(group, minlength=n_data) if N else \
        np.zeros(n_data, np.int64)
    return PartitionPlan(
        n_data, rows_per_group, comm,
        group_sizes=tuple(int(s) for s in sizes),
        method="fennel", shard_n=n,
        perm=perm, slot_of=slot_of, node_group=group.astype(np.int32),
        hub_nodes=hub_nodes, hub_edges=hub_edges,
        hub_cap=int(hub_cap), halo_cap=int(halo_cap),
        hub_send=hub_send.astype(np.int32),
        halo_send=halo_send.astype(np.int32),
        hub_recv=hub_recv.astype(np.int32),
        halo_recv=halo_recv.astype(np.int32),
        edge_work=tuple(int(w) for w in edge_work),
        dedup_pulls=dedup)


def partition_graph(sg, n_data: int, *, pad: bool = False,
                    method: str = "contiguous", hub_cache: int = 0,
                    slack: float = 0.0, alpha: float = 1.0,
                    sweeps: int = 4, seed: int = 0,
                    prev_groups: np.ndarray | None = None,
                    refine_nodes: np.ndarray | None = None,
                    hub_cap: int | None = None,
                    halo_cap: int | None = None) -> PartitionPlan:
    """Assign the shard grid to data groups and build the inter-group
    communication plan.

    ``sg`` is anything with ``.S`` / ``.n`` (grid geometry), ``.occupancy``
    ((S, S) edges per (dst, src) shard) and — for ``method="fennel"`` —
    the per-shard COO edge lists (``edge_src``/``edge_dst``/``edge_valid``):
    a ``core.sharding.ShardedGraph`` or a ``core.engines.GraphTensors``.

    ``method="contiguous"``: ``pad=False`` (default) splits the S rows
    balanced-contiguously (``np.array_split`` semantics); ``pad=True``
    splits ceil(S / n_data) rows to every group as if the grid were
    zero-padded to a multiple of n_data — the equal split the sharded
    program needs (trailing groups own fewer real rows).

    ``method="fennel"``: vertex-granularity streaming placement (always
    padded/equal slot groups — ``pad`` is implied). Knobs:

      * ``hub_cache`` — replicate the top-k out-degree vertices' rows to
        every group per layer and mask their edges out of the halo
        exchange (0 disables hub caching);
      * ``slack`` — fractional headroom on the hub/halo send capacities
        (>0 for mutable graphs so streaming deltas stay in-template);
      * ``prev_groups`` / ``refine_nodes`` — warm-start from a previous
        assignment and re-place only the delta-affected vertices (the
        streaming mutate path);
      * ``hub_cap`` / ``halo_cap`` — pin the compiled capacities; raises
        ValueError when the graph no longer fits (the caller recompiles,
        the stale-build invalidation contract).
    """
    if method == "contiguous":
        return _contiguous_plan(sg, n_data, pad=pad)
    if method != "fennel":
        raise ValueError(f"method must be 'contiguous' or 'fennel', "
                         f"got {method!r}")
    return _fennel_plan(sg, n_data, hub_cache=hub_cache, slack=slack,
                        alpha=alpha, sweeps=sweeps, seed=seed,
                        prev_groups=prev_groups, refine_nodes=refine_nodes,
                        hub_cap=hub_cap, halo_cap=halo_cap)


def balance_report(sg, n_data: int, *, method: str = "contiguous",
                   hub_cache: int = 0) -> dict:
    """Load balance: edges per data group (the straggler predictor).

    The mean — and the imbalance ratio — are taken over groups that
    actually own rows/vertices: empty groups can never straggle, and
    counting them would dilute the mean. The ratio is the true
    ``max / mean`` (no clamp): the historical ``max(mean, 1.0)`` floor
    silently deflated the imbalance whenever mean edge work dropped
    below one edge per group (tiny graphs, large ``n_data``)."""
    plan = partition_graph(sg, n_data, method=method, hub_cache=hub_cache)
    work = np.asarray(plan.edge_work, dtype=np.float64)
    sizes = np.asarray(plan.group_sizes)
    active = work[sizes > 0] if (sizes > 0).any() else work[:0]
    mean = float(active.mean()) if active.size else 0.0
    return {
        "edges_per_group_mean": mean,
        "edges_per_group_max": float(work.max()) if work.size else 0.0,
        "imbalance": plan.edge_imbalance,
        "cross_group_edge_frac": plan.cross_group_edge_frac,
        "group_sizes": plan.group_sizes,
        "method": plan.method,
        "hub_rows": plan.hub_rows,
    }
