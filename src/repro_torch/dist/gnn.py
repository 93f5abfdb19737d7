"""Sharded GNN execution on a (data, model) mesh
(``runtime.compile(..., mesh=...)``).

The port of ``repro.dist.gnn``. The paper's 2-D shard grid carried over
to a device mesh:

  * the **data** axis owns dst row groups: each data group aggregates its
    own destination nodes over its rectangular local grid
    (rows_per_device × S_pad shard pairs) with the shard_spmm kernel,
    through one ``csr.linear_index`` per data group, built at the
    group's first aggregation and kept (model peers share the group's
    grid and index). WHICH rows a group owns is the
    :class:`~repro_torch.graphs.partition.PartitionPlan`'s choice:
    ``partition="contiguous"`` keeps contiguous dst-shard ranges;
    ``partition="fennel"`` places vertices by the locality-aware
    streaming partitioner, and the executable permutes the rows into
    per-group slot ranges (and un-permutes the output, so logits come
    back in the caller's node order);
  * the **model** axis owns feature blocks — the paper's
    dimension-blocking spread across devices: each model rank
    aggregates only its ceil(D / n_model) feature slice, and the dense
    stage reduces the row-parallel partial products (dense_engine) with
    a ``psum``;
  * per layer, each rank gathers the source rows of its feature block
    over the data axis. Contiguous plans all-gather EVERY row; fennel
    plans exchange only the **hub broadcast** (top-k out-degree rows
    replicated to every group) plus the **halo all-gather** (each
    group's non-hub boundary vertices), and layer 0 is collective-free:
    the permuted input is replicated, so the first layer reads its
    sources locally.

The program is written once per rank over the mesh's lists
(:mod:`repro_torch.dist.mesh`) and runs on a ``LocalMesh`` (all ranks in
this process, on one device) or a ``ProcessGroupMesh`` (one rank per
process). Its collectives are counted into the mesh's comm log;
:meth:`ShardedExecutable.verify_comm` holds the count to the analytic
per-layer model and the plan's model (``analyze/comm_lint.py``).

Supported archs: the linear-aggregation family (``gcn``, ``sage_mean``,
``gin``). ``sage_max`` (edge-list max pooling) and ``gat`` (attention
weights per nonzero) raise ``NotImplementedError`` at compile, as in
the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.graphs.partition import PartitionPlan, partition_graph
from repro_torch.kernels import csr
from repro_torch.kernels.ref import _activate
from repro_torch.runtime.executable import Executable
from repro_torch.runtime.forward import layer_activation

SUPPORTED_ARCHS = ("gcn", "sage_mean", "gin")
PARTITION_METHODS = ("contiguous", "fennel")

_F32 = 4


def _pad_last(x: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad the trailing (feature) dim up to ``size``."""
    pad = size - x.shape[-1]
    return x if pad <= 0 else F.pad(x, (0, pad))


def _feature_block(x: torch.Tensor, m: int, bm: int,
                   n_model: int) -> torch.Tensor:
    """Model rank m's feature block: pad D to bm·n_model and take columns
    [m·bm, (m+1)·bm) (contiguous: the kernels take contiguous rows)."""
    return _pad_last(x, bm * n_model).narrow(-1, m * bm, bm).contiguous()


def _weight_block(w: torch.Tensor, row_off: int, rows: int, m: int, bm: int,
                  n_model: int) -> torch.Tensor:
    """Rows [row_off, row_off+rows) of ``w``, zero-padded to bm·n_model
    rows, then model rank m's bm-row block: the row-parallel half of the
    partial product (zero rows pair with zero-padded features)."""
    wp = w[row_off:row_off + rows]
    if bm * n_model > rows:
        wp = F.pad(wp, (0, 0, 0, bm * n_model - rows))
    return wp.narrow(0, m * bm, bm)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card (an unset index is the
    current one)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class _GraphArgs:
    """One version of the sharded graph arguments: the (padded, for
    fennel permuted) grid and the plan's index tensors, each data group's
    rows of the grid (views, which the group's model peers share) and
    each group's ``csr.linear_index``, built at its first aggregation
    (outside inference mode: a graph first served may be trained on) and
    kept with these arguments."""

    def __init__(self, args: dict, rows_per_device: int, n_data: int):
        self.args = args
        r = rows_per_device
        self.group_blocks = [args["blocks"][g * r:(g + 1) * r]
                             for g in range(n_data)]
        self._indexes: list | None = None

    def indexes(self) -> list:
        if self._indexes is None:
            with torch.inference_mode(False):
                self._indexes = [csr.linear_index(b)
                                 for b in self.group_blocks]
        return self._indexes


class ShardedExecutable(Executable):
    """An :class:`~repro_torch.runtime.executable.Executable` whose
    forward runs on a ``(data, model)`` mesh.

    Everything above the forward — the cached full-graph softmax,
    ``predict``/``step``, parameter reloads, plan serialization — is
    inherited: the sharded forward returns the same (N, C) logits,
    computed across the mesh. The caller's rows are assembled (and
    fennel's slot order un-permuted) outside the comm contract, as the
    reference does it outside its measured module."""

    def __init__(self, *, mesh, partition: str = "contiguous",
                 hub_cache: int = 256, partition_slack: float = 0.0, **kw):
        sizes = dict(mesh.shape)
        if set(sizes) != {"data", "model"}:
            raise ValueError(
                f"sharded execution needs a ('data', 'model') mesh "
                f"(launch.mesh.make_mesh_for builds one); got axes "
                f"{tuple(sizes)}")
        if partition not in PARTITION_METHODS:
            raise ValueError(f"partition must be one of "
                             f"{PARTITION_METHODS}; got {partition!r}")
        spec, gt = kw["spec"], kw["gt"]
        if spec.arch not in SUPPORTED_ARCHS:
            raise NotImplementedError(
                f"sharded execution supports {SUPPORTED_ARCHS}; "
                f"{spec.arch!r} needs sharded gather/attention kernels")
        if not _same_device(gt.device, mesh.device):
            raise ValueError(f"the graph lives on {gt.device}, the mesh on "
                             f"{mesh.device}")
        self.mesh = mesh
        self.n_data, self.n_model = sizes["data"], sizes["model"]
        self.partition_method = partition
        self.hub_cache = int(hub_cache)
        # capacity headroom on the fennel hub/halo send slots (> 0 for
        # mutable graphs, so streaming deltas stay within the compiled
        # capacities; 0 for frozen graphs: the tightest wire volume)
        self.partition_slack = float(partition_slack)
        # pad the grid so every data group owns the same number of dst
        # rows (trailing padded rows/slots hold no nodes and no edges)
        self.rows_per_device = -(-gt.S // self.n_data)
        self.S_pad = self.rows_per_device * self.n_data
        self.partition: PartitionPlan | None = None
        self._adopt(*self._build_args(gt))
        super().__init__(**kw)

    # -- graph arguments ---------------------------------------------------

    def _permute_blocks(self, gt, slot_of: np.ndarray) -> torch.Tensor:
        """The plan's row permutation applied to the normalized grid: the
        padded (S_pad, S_pad, n, n) grid whose entry at slots (s, t) is
        the original A[perm[s], perm[t]] (zero at empty slots). The
        reference densifies the (N+1)² matrix and gathers its rows and
        columns; this writes the nonzeros to their slots instead (the
        same values, without an (N+1)² copy at Pubmed's 1.6 GB)."""
        n, sp = gt.n, self.S_pad
        ii, jj, vv, uu = gt.blocks.nonzero(as_tuple=True)
        vals = gt.blocks[ii, jj, vv, uu]
        slot = torch.as_tensor(slot_of, dtype=torch.int64, device=gt.device)
        rs, cs = slot[ii * n + vv], slot[jj * n + uu]
        out = torch.zeros((sp, sp, n, n), dtype=gt.blocks.dtype,
                          device=gt.device)
        out[rs // n, cs // n, rs % n, cs % n] = vals
        return out

    def _build_args(self, gt, *, refine_nodes=None):
        """(plan, graph args, host ms) for ``gt``. Contiguous: the padded
        grid. Fennel: the permuted grid and the plan's index tensors; after
        construction the compiled hub/halo capacities are pinned, so a
        graph delta that no longer fits raises ValueError (from
        ``partition_graph``) — the stale-build contract the serving
        engine's mutate answers with a recompile."""
        t0 = time.perf_counter()
        dev = gt.device
        with torch.inference_mode(False):
            if self.partition_method == "contiguous":
                plan = partition_graph(gt, self.n_data, pad=True)
                host_ms = (time.perf_counter() - t0) * 1e3
                pad = self.S_pad - gt.S
                blocks = gt.blocks if pad == 0 else F.pad(
                    gt.blocks, (0, 0, 0, 0, 0, pad, 0, pad))
                return plan, {"blocks": blocks}, host_ms
            prev = pinned_hub = pinned_halo = None
            cur = self.partition
            if cur is not None and cur.method == "fennel":
                pinned_hub, pinned_halo = cur.hub_cap, cur.halo_cap
                if cur.node_group is not None and \
                        len(cur.node_group) == gt.S * gt.n:
                    prev = cur.node_group
            plan = partition_graph(
                gt, self.n_data, method="fennel", hub_cache=self.hub_cache,
                slack=self.partition_slack, prev_groups=prev,
                refine_nodes=refine_nodes if prev is not None else None,
                hub_cap=pinned_hub, halo_cap=pinned_halo)
            host_ms = (time.perf_counter() - t0) * 1e3

            def put(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                       device=dev)

            args = {"blocks": self._permute_blocks(gt, plan.slot_of),
                    "perm_src": put(np.where(plan.perm < 0, gt.S * gt.n,
                                             plan.perm)),
                    "slot_of": put(plan.slot_of),
                    "hub_send": put(plan.hub_send),
                    "halo_send": put(plan.halo_send),
                    "hub_recv": put(plan.hub_recv),
                    "halo_recv": put(plan.halo_recv)}
            return plan, args, host_ms

    def _adopt(self, plan, args, host_ms) -> None:
        """Make ``args`` the graph arguments; their per-group indexes are
        built from them at the next aggregation (an earlier forward keeps
        the old arguments and indexes, a consistent snapshot)."""
        self.partition, self.partition_host_ms = plan, host_ms
        self._graph = _GraphArgs(args, self.rows_per_device, self.n_data)

    def group_blocks(self) -> list:
        """Each data group's rows of the grid: its (rows_per_device,
        S_pad, n, n) local grid."""
        return self._graph.group_blocks

    def group_indexes(self) -> list:
        """Each data group's ``csr.linear_index`` of its local grid."""
        return self._graph.indexes()

    def update_graph(self, gt, h_grouped=None, *, stale_nodes=None,
                     refine_nodes=None) -> int:
        """Adopt post-delta graph tensors (see the base class). Fennel
        re-partitions FIRST, warm-started from the current placement with
        the delta-affected vertices re-scored (``refine_nodes``, the
        patch's pair rows, else ``stale_nodes``); it raises ValueError on
        a capacity overflow before anything is adopted."""
        self._check_template(gt, h_grouped)
        refine = refine_nodes if refine_nodes is not None else stale_nodes
        built = self._build_args(gt, refine_nodes=refine)
        n = super().update_graph(gt, h_grouped, stale_nodes=stale_nodes)
        self._adopt(*built)
        return n

    # -- the sharded program -----------------------------------------------

    def _layer(self, graph: "_GraphArgs", i: int, layer: dict,
               hb_loc: list, hb_full: list, d: int) -> list:
        """One zoo layer on each rank's dst rows and feature block.
        ``hb_loc``: the rank's rows of its block; ``hb_full``: the full
        (S_pad, n, bm) source block however it was exchanged; ``d``: the
        true input width."""
        spec, be, mesh, nm = self.spec, self.backend, self.mesh, self.n_model
        act = layer_activation(spec, i)
        ranks = mesh.local_ranks
        blocks, idx = graph.group_blocks, graph.indexes()
        s_loc, n, bm = hb_loc[0].shape
        rows = s_loc * n
        agg = [be.graph_aggregate(blocks[g], hf, index=idx[g])
               for (g, _), hf in zip(ranks, hb_full)]
        if spec.arch == "gcn":
            z = [be.dense_matmul(a.reshape(rows, bm),
                                 _weight_block(layer["w"], 0, d, m, bm, nm))
                 for (_, m), a in zip(ranks, agg)]
        elif spec.arch == "sage_mean":
            # cat([agg, h]) @ w == agg @ w[:d] + h @ w[d:]
            z = [be.dense_matmul(a.reshape(rows, bm),
                                 _weight_block(layer["w"], 0, d, m, bm, nm))
                 + be.dense_matmul(hb.reshape(rows, bm),
                                   _weight_block(layer["w"], d, d, m, bm, nm))
                 for (_, m), a, hb in zip(ranks, agg, hb_loc)]
        else:   # gin: a two-product MLP, a psum after each product
            part = [be.dense_matmul(
                ((1.0 + layer["eps"]) * hb + a).reshape(rows, bm),
                _weight_block(layer["w1"], 0, d, m, bm, nm))
                for (_, m), a, hb in zip(ranks, agg, hb_loc)]
            hid = [torch.relu(x + layer["b1"])
                   for x in mesh.psum(part, "model")]
            dh = hid[0].shape[-1]
            bm2 = -(-dh // nm)
            part = [be.dense_matmul(
                _feature_block(x, m, bm2, nm),
                _weight_block(layer["w2"], 0, dh, m, bm2, nm))
                for (_, m), x in zip(ranks, hid)]
            return [_activate(x + layer["b2"], act).reshape(s_loc, n, -1)
                    for x in mesh.psum(part, "model")]
        # row-parallel partial products -> full output columns
        return [_activate(x, act).reshape(s_loc, n, -1)
                for x in mesh.psum(z, "model")]

    def _assemble_sources(self, hb_loc: list, args: dict) -> list:
        """Fennel, layers >= 1: each rank's full (S_pad, n, bm) source
        block. The hub broadcast and the halo all-gather are written into
        a zero buffer (dummy slots land on a sacrificial trailing row),
        then the rank's own slot range is written last, so overlapped
        slots take their values, and their cotangents, from the rank's
        own rows alone (out-of-place ``index_copy`` and ``cat``, which
        autograd follows)."""
        mesh, plan = self.mesh, self.partition
        ranks = mesh.local_ranks
        s_loc, n, bm = hb_loc[0].shape
        loc_n, tot = s_loc * n, self.S_pad * n
        flats = [hb.reshape(loc_n, bm) for hb in hb_loc]
        owns = [torch.cat([f, f.new_zeros((1, bm))]) for f in flats]
        bufs = [flats[0].new_zeros((tot + 1, bm))] * len(ranks)
        for cap, send, recv in ((plan.hub_cap, "hub_send", "hub_recv"),
                                (plan.halo_cap, "halo_send", "halo_recv")):
            if cap:
                got = mesh.all_gather([own[args[send][g]] for (g, _), own
                                       in zip(ranks, owns)], "data")
                bufs = [b.index_copy(0, args[recv], x)
                        for b, x in zip(bufs, got)]
        return [torch.cat([b[:g * loc_n], f, b[(g + 1) * loc_n:tot]])
                .reshape(self.S_pad, n, bm)
                for (g, _), b, f in zip(ranks, bufs, flats)]

    def _program(self, graph: "_GraphArgs", p: dict,
                 h: torch.Tensor) -> list:
        """The per-rank program: h (S, n, in_dim) grouped features ->
        each local rank's (rows_per_device, n, C) logits."""
        mesh, nm, r = self.mesh, self.n_model, self.rows_per_device
        ranks, args = mesh.local_ranks, graph.args
        fennel = self.partition_method == "fennel"
        if fennel:
            # permute into slot order (empty slots -> an appended zero
            # row); the input is replicated, so this is collective-free
            d = h.shape[-1]
            hflat = torch.cat([h.reshape(-1, d), h.new_zeros((1, d))])
            hp = hflat[args["perm_src"]].reshape(self.S_pad, self.gt.n, d)
        else:
            pad = self.S_pad - h.shape[0]
            hp = h if pad == 0 else F.pad(h, (0, 0, 0, 0, 0, pad))
        h_loc = [hp[g * r:(g + 1) * r] for g, _ in ranks]
        for i, layer in enumerate(p["layers"]):
            d = h_loc[0].shape[-1]
            bm = -(-d // nm)
            # distributed dimension-blocking: slice the rank's feature
            # block FIRST, then exchange only that block's source rows
            hb_loc = [_feature_block(x, m, bm, nm)
                      for (_, m), x in zip(ranks, h_loc)]
            if fennel and i == 0:
                full = {m: _feature_block(hp, m, bm, nm)
                        for m in sorted({m for _, m in ranks})}
                hb_full = [full[m] for _, m in ranks]
            elif fennel:
                hb_full = self._assemble_sources(hb_loc, args)
            else:
                hb_full = mesh.all_gather(hb_loc, "data")
            h_loc = self._layer(graph, i, layer, hb_loc, hb_full, d)
        return h_loc

    def _forward_fn(self):
        """``(params, h_grouped) -> (N, C)`` logits in the caller's node
        order, recorded by autograd: the program, then the caller's rows
        assembled and (fennel) un-permuted, outside the comm contract."""
        graph, mesh = self._graph, self.mesh
        tot, num_nodes = self.S_pad * self.gt.n, self.gt.num_nodes

        def fwd(p, h):
            out = mesh.assemble(self._program(graph, p, h)).reshape(tot, -1)
            if self.partition_method == "fennel":
                out = out[graph.args["slot_of"]]
            return out[:num_nodes]

        return fwd

    # -- communication accounting ------------------------------------------

    def _layer_allgather_bytes(self) -> list[float]:
        """Analytic per-layer all-gather wire bytes of the program above
        (the comm log's convention: gathered result × (g - 1)).

        ``contiguous``: each model rank gathers its ceil(d / n_model)
        feature block of every row — (n_data-1)·S_pad·n·bm·4 per layer.

        ``fennel``: layer 0 is collective-free (replicated input); every
        later layer ships the hub broadcast + halo all-gather —
        (n_data-1)·n_data·(hub_cap+halo_cap)·bm·4."""
        out = []
        for i, (d, _) in enumerate(self.spec.layer_dims):
            bm = -(-d // self.n_model)
            if self.partition_method == "fennel":
                caps = self.partition.hub_cap + self.partition.halo_cap
                out.append(0.0 if i == 0 else float(
                    (self.n_data - 1) * self.n_data * caps * bm * _F32))
            else:
                out.append(float((self.n_data - 1) * self.S_pad * self.gt.n
                                 * bm * _F32))
        return out

    def comm_stats(self) -> dict:
        """Counted vs modeled cross-device traffic of one forward.

        ``measured_*`` come from the comm log of one forward run here;
        ``expected_allgather_wire_bytes`` is the analytic model above;
        ``plan_*`` are the PartitionPlan's graph-level models (dedup
        pulls, halo broadcast, hub broadcast)."""
        h = self._h_grouped
        if h is None:
            h = torch.zeros((self.gt.S, self.gt.n, self.spec.in_dim),
                            device=self.device)
        with torch.inference_mode(), self.mesh.comm.capture() as log:
            self._forward_fn()(self.params, h)
        stats = log.stats()
        dims = [d for d, _ in self.spec.layer_dims]
        fennel = self.partition_method == "fennel"
        plan = self.partition

        def plan_ag(i, d):
            if fennel and i == 0:
                return 0.0
            return plan.allgather_bytes_per_layer(
                -(-d // self.n_model), self.gt.n, dtype_bytes=_F32)

        def plan_hub(i, d):
            if not fennel or i == 0:
                return 0.0
            return plan.hub_bytes_per_layer(-(-d // self.n_model),
                                            dtype_bytes=_F32)

        return {
            "n_data": self.n_data,
            "n_model": self.n_model,
            "partition_method": self.partition_method,
            "hub_rows": plan.hub_rows,
            "hub_cap": plan.hub_cap,
            "halo_cap": plan.halo_cap,
            "measured_wire_bytes": dict(stats.wire_bytes),
            "measured_counts": dict(stats.counts),
            "measured_allgather_wire_bytes":
                stats.wire_bytes.get("all-gather", 0.0),
            "measured_allgather_ops": log.allgather_ops(),
            "expected_allgather_wire_bytes":
                sum(self._layer_allgather_bytes()),
            "plan_transfer_bytes_per_layer": {
                str(i): plan.transfer_bytes_per_layer(d, dtype_bytes=_F32)
                for i, d in enumerate(dims)},
            "plan_allgather_bytes_per_layer": {
                str(i): plan_ag(i, d) for i, d in enumerate(dims)},
            "plan_hub_bytes_per_layer": {
                str(i): plan_hub(i, d) for i, d in enumerate(dims)},
            "cross_group_edge_frac": plan.cross_group_edge_frac,
        }

    def verify_comm(self, rtol: float = 0.02) -> dict:
        """Assert the counted all-gather volume matches both the analytic
        per-layer model and the PartitionPlan's broadcast model (hub terms
        included): the comm contract of ``analyze/comm_lint.py``, its
        error findings raised as an AssertionError. Returns
        :meth:`comm_stats`."""
        from repro_torch.analyze.comm_lint import check_comm_stats

        cs = self.comm_stats()
        errors = [f for f in check_comm_stats(cs, rtol=rtol)
                  if f.severity == "error"]
        if errors:
            raise AssertionError("\n".join(f.render() for f in errors))
        return cs

    # -- introspection -----------------------------------------------------

    def summary(self) -> str:
        head = super().summary()
        plan = self.partition
        extra = ""
        if plan.method == "fennel":
            extra = (f" hubs={plan.hub_rows} "
                     f"(caps hub={plan.hub_cap} halo={plan.halo_cap})")
        return (head + f"\nmesh: {type(self.mesh).__name__} "
                f"data={self.n_data} model={self.n_model} "
                f"partition={plan.method} "
                f"rows/group={self.rows_per_device} (grid padded "
                f"{self.gt.S}->{self.S_pad}) "
                f"cross-group edges {plan.cross_group_edge_frac:.1%}, "
                f"edge imbalance {plan.edge_imbalance:.2f}x" + extra)
