"""Incremental shard-grid patching for streaming graphs.

The port of ``repro.graphs.patch``: the host part (:class:`PatchState`,
``apply``, compaction, ``verify_against_rebuild``) is numpy, held
bitwise to the reference by tests/test_torch_stream.py; the device part
is :meth:`PatchState.to_graph_tensors`.

A :class:`PatchState` is the mutable numpy master copy of one sharded,
normalization-baked graph build — the same (S, S, n, n) dense blocks and
(S, S, E_cap) padded per-shard edge lists ``core/sharding.py`` produces,
except the edge-list E dimension carries **slack slots** (``slack`` extra
capacity) so in-template inserts never change the array shapes the jitted
forward was traced with.

``apply(delta)`` is amortized-incremental: it recomputes only the
*affected shard pairs* — the pairs holding inserted/removed edges, plus
(normalization-dependent) every pair holding an edge whose baked weight a
degree change reweights — each rewritten **wholesale from the canonical
edge list**, in canonical order. That wholesale-per-pair rewrite is what
makes the result bitwise-identical to a from-scratch
``shard_graph``/``build_graph_tensors`` rebuild (same per-cell float32
accumulation sequence, same per-slot COO order); the slack slots only
provide capacity, never an append-out-of-order fast path.

When a delta overflows a pair's capacity (or grows the node count past
S·n), the state **compacts**: a full rebuild with fresh slack. The shapes
may change, which forces the consumer (Executable.update_graph) to
recompile — the trade tracked by ``PatchResult.rebuilt``.

On the device a patch is copy-on-write: :meth:`PatchState.to_graph_tensors`
returns a NEW :class:`~repro_torch.core.engines.GraphTensors` and never
writes into the previous one's tensors. The CSR indexes the kernels walk
(``GraphTensors.linear_index`` / ``gather_index``) are kept per object, so
the new object builds its own from the patched tensors at its first use,
and the pre-delta object — still held by an in-flight batch or a
trainer's executable — stays a consistent snapshot.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from repro_torch.core.engines import GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.models import graph_signature
from repro_torch.graphs.delta import (GraphDelta, apply_to_edge_list,
                                      removed_edge_mask)
from repro_torch.utils import cdiv


def _slack_capacity(e_max: int, slack: float) -> int:
    """Padded E with slack: proportional headroom, floor 8 extra slots so
    tiny shards can still take inserts. slack=0 means NO headroom (the
    known-bad template: the first insert into the fullest pair
    compacts)."""
    if slack <= 0:
        return e_max
    return e_max + max(int(np.ceil(e_max * slack)), 8)


@dataclasses.dataclass
class PatchResult:
    """What one ``apply`` did (and what it cost)."""

    rebuilt: bool                 # compaction: shapes may have changed
    reason: str | None            # why it compacted (None when patched)
    shards_patched: int           # affected pairs rewritten (S² on rebuild)
    shards_total: int             # S² after the apply
    edges_added: int
    edges_removed: int
    nodes_added: int
    num_nodes: int                # post-delta node count
    apply_ms: float
    pairs: tuple | None = None    # (ai, aj) affected pair indices


def pair_rows(pairs: tuple | None, n: int, num_nodes: int) -> np.ndarray | None:
    """Flat vertex ids living in a patch's affected shard rows/cols.

    Maps a :class:`PatchResult`'s ``(ai, aj)`` affected pair indices to
    the union of vertices in those dst rows and src cols — every vertex
    whose incident edges a delta could have rewritten. This is the
    re-score hint for placement-maintaining executables (the fennel
    partitioner in ``dist/gnn.py``): only these vertices need their
    group assignment revisited after a streaming mutate; coarser than
    the k-hop affected set but available even when targeted invalidation
    is off. ``None`` pairs (compaction rebuild) -> ``None`` (re-score
    everything the caller wants). ``GNNServeEngine.mutate`` passes it to
    every executable's ``update_graph``."""
    if pairs is None:
        return None
    ai, aj = (np.asarray(p, dtype=np.int64) for p in pairs)
    shards = np.unique(np.concatenate([ai, aj]))
    rows = (shards[:, None] * n + np.arange(n)[None, :]).ravel()
    return rows[rows < num_nodes]


class PatchState:
    """Mutable numpy mirror of one sharded graph build (see module doc)."""

    def __init__(self, edges: np.ndarray, num_nodes: int, n: int, *,
                 normalize: str = "gcn", add_self_loops: bool = True,
                 slack: float = 0.25, edge_capacity: int | None = None):
        self.normalize = normalize
        self.loops = bool(add_self_loops)
        self.slack = float(slack)
        self.n = int(n)
        self.stats = {"applies": 0, "shards_patched_total": 0,
                      "compactions": 0, "apply_ms_total": 0.0}
        self._init_from(np.asarray(edges, dtype=np.int64), int(num_nodes),
                        edge_capacity=edge_capacity)

    @classmethod
    def for_arch(cls, edges, num_nodes: int, n: int, arch: str, *,
                 slack: float = 0.25) -> "PatchState":
        """Build for a zoo architecture's graph signature (the same
        mapping ``build_graph_tensors`` uses)."""
        norm, loops = graph_signature(arch)
        return cls(edges, num_nodes, n, normalize=norm,
                   add_self_loops=loops, slack=slack)

    # -- construction ------------------------------------------------------

    def _init_from(self, edges: np.ndarray, num_nodes: int, *,
                   edge_capacity: int | None = None) -> None:
        sg = shard_graph(edges, num_nodes, self.n,
                         add_self_loops=self.loops,
                         normalize=self.normalize)
        e_max = sg.edge_src.shape[2]
        cap = edge_capacity if edge_capacity is not None else \
            _slack_capacity(e_max, self.slack)
        if cap < e_max:
            raise ValueError(f"edge_capacity {cap} < required {e_max}")
        pad = ((0, 0), (0, 0), (0, cap - e_max))
        self.edges = np.ascontiguousarray(edges)
        self.num_nodes = num_nodes
        self.S = sg.S
        self.e_cap = cap
        self.blocks = sg.blocks                       # (S, S, n, n) f32
        self.edge_src = np.pad(sg.edge_src, pad)      # (S, S, e_cap) i32
        self.edge_dst = np.pad(sg.edge_dst, pad)
        self.edge_valid = np.pad(sg.edge_valid, pad)
        self.counts = np.asarray(sg.occupancy, dtype=np.int64)
        self.deg_in, self.deg_out = self._degrees(edges, num_nodes)

    def _degrees(self, edges: np.ndarray,
                 num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
        """(deg_in, deg_out) over the padded id space, self loops
        included — float64 integer sums, bitwise-stable under
        reordering, matching shard_graph's normalization inputs."""
        n_padded = self.S * self.n if hasattr(self, "S") else \
            cdiv(num_nodes, self.n) * self.n
        src, dst = edges[:, 0], edges[:, 1]
        deg_in = np.zeros(n_padded, dtype=np.float64)
        deg_out = np.zeros(n_padded, dtype=np.float64)
        np.add.at(deg_in, dst, 1.0)
        np.add.at(deg_out, src, 1.0)
        if self.loops:
            deg_in[:num_nodes] += 1.0
            deg_out[:num_nodes] += 1.0
        return deg_in, deg_out

    def _weights(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Baked edge weights from the CURRENT degree arrays — the exact
        elementwise float64 expression shard_graph uses."""
        if self.normalize == "gcn":
            return 1.0 / np.sqrt(np.maximum(self.deg_out[src], 1.0)
                                 * np.maximum(self.deg_in[dst], 1.0))
        if self.normalize == "mean":
            return 1.0 / np.maximum(self.deg_in[dst], 1.0)
        return np.ones(src.shape[0], dtype=np.float64)

    # -- the patch ---------------------------------------------------------

    def apply(self, delta: GraphDelta) -> PatchResult:
        """Apply one delta; returns what happened. Raises (state
        untouched) on an invalid delta."""
        t0 = time.perf_counter()
        removed = self.edges[removed_edge_mask(self.edges, delta)]
        new_edges, new_num = apply_to_edge_list(self.edges, self.num_nodes,
                                                delta)
        n, S = self.n, self.S
        res_kw = dict(edges_added=int(delta.add_edges.shape[0]),
                      edges_removed=int(removed.shape[0]),
                      nodes_added=delta.add_nodes, num_nodes=new_num)

        if new_num > S * n:
            return self._compact(new_edges, new_num, t0,
                                 reason="node-capacity", **res_kw)

        deg_in, deg_out = self._degrees(new_edges, new_num)
        # nodes whose degree changed reweight their incident baked edges
        din_chg = deg_in != self.deg_in
        dout_chg = deg_out != self.deg_out

        # --- affected shard pairs (dst shard row, src shard col) ---------
        aff = np.zeros((S, S), dtype=bool)

        def mark(e):
            if e.shape[0]:
                aff[e[:, 1] // n, e[:, 0] // n] = True

        mark(removed)
        mark(delta.add_edges)
        src_a, dst_a = new_edges[:, 0], new_edges[:, 1]
        if self.normalize == "gcn":
            mark(new_edges[dout_chg[src_a] | din_chg[dst_a]])
        elif self.normalize == "mean":
            mark(new_edges[din_chg[dst_a]])
        if self.loops:
            # self loops of degree-changed / new nodes live on the diagonal
            chg = np.flatnonzero(din_chg | dout_chg)
            chg = chg[chg < new_num]
            if self.normalize in ("gcn", "mean") and chg.size:
                aff[chg // n, chg // n] = True
            new_ids = np.arange(self.num_nodes, new_num)
            if new_ids.size:
                aff[new_ids // n, new_ids // n] = True

        ai, aj = np.nonzero(aff)
        if ai.size == 0:    # weight-neutral no-op delta
            self.edges, self.num_nodes = new_edges, new_num
            self.deg_in, self.deg_out = deg_in, deg_out
            return self._result(t0, rebuilt=False, reason=None,
                                shards_patched=0, pairs=(ai, aj), **res_kw)

        # --- canonical content of the affected pairs ---------------------
        # commit degrees FIRST: _weights reads them
        old_deg = (self.deg_in, self.deg_out)
        self.deg_in, self.deg_out = deg_in, deg_out
        sel = aff[dst_a // n, src_a // n]
        csrc, cdst = src_a[sel], dst_a[sel]
        if self.loops:
            ids = np.arange(new_num, dtype=np.int64)
            lsel = aff[ids // n, ids // n]
            lids = ids[lsel]
            # canonical order: real edges first, then self loops by id —
            # exactly shard_graph's concatenate([edges, loops]) layout
            csrc = np.concatenate([csrc, lids])
            cdst = np.concatenate([cdst, lids])

        csi, csj = cdst // n, csrc // n
        cnt = np.zeros((S, S), dtype=np.int64)
        np.add.at(cnt, (csi, csj), 1)
        if int(cnt[ai, aj].max(initial=0)) > self.e_cap:
            self.deg_in, self.deg_out = old_deg     # roll back for _compact
            return self._compact(new_edges, new_num, t0,
                                 reason="edge-capacity", **res_kw)

        w = self._weights(csrc, cdst).astype(np.float32)
        lv, lu = cdst % n, csrc % n

        # --- wholesale rewrite of each affected pair ---------------------
        self.blocks[ai, aj] = 0.0
        np.add.at(self.blocks, (csi, csj, lv, lu), w)
        self.edge_src[ai, aj] = 0
        self.edge_dst[ai, aj] = 0
        self.edge_valid[ai, aj] = False
        order = np.lexsort((csj, csi))               # stable: keeps
        flat = csi[order] * S + csj[order]           # canonical order
        pos = np.zeros_like(flat)
        if len(flat):
            new_shard = np.concatenate([[True], flat[1:] != flat[:-1]])
            idx_in_run = np.arange(len(flat))
            run_start = np.maximum.accumulate(
                np.where(new_shard, idx_in_run, 0))
            pos = idx_in_run - run_start
        self.edge_src[csi[order], csj[order], pos] = lu[order]
        self.edge_dst[csi[order], csj[order], pos] = lv[order]
        self.edge_valid[csi[order], csj[order], pos] = True
        self.counts[ai, aj] = cnt[ai, aj]

        self.edges, self.num_nodes = new_edges, new_num
        return self._result(t0, rebuilt=False, reason=None,
                            shards_patched=int(ai.size), pairs=(ai, aj),
                            **res_kw)

    def _compact(self, new_edges: np.ndarray, new_num: int, t0: float, *,
                 reason: str, **res_kw) -> PatchResult:
        """Full rebuild with fresh slack — the periodic compaction path.
        Shapes (S and/or E_cap) may change; the consumer must re-check
        its template."""
        self._init_from(new_edges, new_num)
        self.stats["compactions"] += 1
        return self._result(t0, rebuilt=True, reason=reason,
                            shards_patched=self.S * self.S, pairs=None,
                            **res_kw)

    def _result(self, t0: float, **kw) -> PatchResult:
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["applies"] += 1
        self.stats["shards_patched_total"] += kw.get("shards_patched", 0)
        self.stats["apply_ms_total"] += ms
        return PatchResult(shards_total=self.S * self.S, apply_ms=ms, **kw)

    # -- consumers ---------------------------------------------------------

    def to_graph_tensors(self, prev=None, pairs: tuple | None = None, *,
                         device: torch.device | str | None = None):
        """Device :class:`~repro_torch.core.engines.GraphTensors` of the
        current state, always a NEW object.

        With ``prev`` (the pre-delta tensors, same template) and ``pairs``
        (the affected pair indices from the PatchResult), ``prev``'s four
        tensors are cloned on the device and only the affected ``(ai, aj)``
        slices are uploaded from the host mirror into the clones — the
        reference's ``old.at[ai, aj].set(new)``, which is a copy too.
        ``prev``'s tensors are never written, so its kept CSR indexes stay
        true to them. Otherwise every tensor is uploaded whole, to
        ``prev``'s device or else to ``device``, which a call without
        ``prev`` must name (``ValueError`` if it does not: nothing lands
        on the CPU unless the caller asks for it). The copies run on the
        current stream, ordered with the forwards, and outside inference
        mode so a trainer can later save them for a backward."""
        if prev is None and device is None:
            raise ValueError("to_graph_tensors needs prev or a device")
        dev = prev.device if prev is not None else torch.device(device)
        host = (self.blocks, self.edge_src, self.edge_dst, self.edge_valid)
        with torch.inference_mode(False):
            if prev is not None and pairs is not None and \
                    tuple(prev.edge_src.shape) == self.edge_src.shape \
                    and prev.S == self.S:
                ai, aj = (np.asarray(p, dtype=np.int64) for p in pairs)
                olds = (prev.blocks, prev.edge_src, prev.edge_dst,
                        prev.edge_valid)
                if ai.size == 0:
                    arrs = olds
                else:
                    ti = torch.from_numpy(ai).to(dev)
                    tj = torch.from_numpy(aj).to(dev)
                    arrs = []
                    for old, new in zip(olds, host):
                        out = old.clone()
                        out[ti, tj] = torch.from_numpy(
                            np.ascontiguousarray(new[ai, aj])).to(dev)
                        arrs.append(out)
            else:
                # copy=True: on the CPU a plain .to() would alias the
                # host mirror, which the next apply() rewrites in place
                arrs = tuple(torch.from_numpy(a).to(dev, copy=True)
                             for a in host)
        return GraphTensors(blocks=arrs[0], edge_src=arrs[1],
                            edge_dst=arrs[2], edge_valid=arrs[3],
                            num_nodes=self.num_nodes, n=self.n, S=self.S)

    def verify_against_rebuild(self) -> None:
        """Element-wise check against a from-scratch shard_graph rebuild:
        blocks bitwise-equal, COO prefix bitwise-equal, slack slots
        invalid, degrees equal. AssertionError on any drift — the
        correctness oracle the streaming tests drive."""
        sg = shard_graph(self.edges, self.num_nodes, self.n,
                         add_self_loops=self.loops,
                         normalize=self.normalize)
        assert sg.S == self.S, (sg.S, self.S)
        assert np.array_equal(sg.blocks, self.blocks), \
            "dense blocks drifted from rebuild"
        e_fresh = sg.edge_src.shape[2]
        assert e_fresh <= self.e_cap, (e_fresh, self.e_cap)
        for name, mine, fresh in (("edge_src", self.edge_src, sg.edge_src),
                                  ("edge_dst", self.edge_dst, sg.edge_dst),
                                  ("edge_valid", self.edge_valid,
                                   sg.edge_valid)):
            assert np.array_equal(mine[..., :e_fresh], fresh), \
                f"{name} prefix drifted from rebuild"
        assert not self.edge_valid[..., e_fresh:].any(), \
            "slack slots marked valid"
        assert np.array_equal(self.counts, np.asarray(sg.occupancy)), \
            "per-shard counts drifted"
        assert np.array_equal(self.deg_in, sg.degrees), \
            "in-degrees drifted"


def fullest_pair_insert(ps: PatchState) -> GraphDelta:
    """A GraphDelta inserting one new edge into the shard pair with the
    least headroom: the first insert an unpadded (slack 0) template
    cannot absorb."""
    i, j = np.unravel_index(np.argmax(ps.counts), ps.counts.shape)
    have = {(int(u), int(v)) for u, v in ps.edges}
    for u in range(j * ps.n, min((j + 1) * ps.n, ps.num_nodes)):
        for v in range(i * ps.n, min((i + 1) * ps.n, ps.num_nodes)):
            if u != v and (u, v) not in have:
                return GraphDelta(add_edges=np.array([[u, v]]))
    raise ValueError("the fullest shard pair is completely dense")
