"""Production-mesh dry-run: the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single [--out results/dryrun]

For each (arch x shape x mesh) cell it traces one step of the model on
the reference's production mesh — (16, 16) ``("data", "model")``, or
(2, 16, 16) ``("pod", "data", "model")`` — and writes one JSON record
per cell: the per-device FLOPs and bytes accessed, the per-device
memory, and the collectives (bytes, counts, ring wire bytes) that one
rank issues. :func:`main` creates a fake process group of 256 or 512
ranks (no communication, no devices) and the ``DeviceMesh`` on it;
nothing happens at import.

Method. Everything runs on meta tensors from the abstract parameter
trees (``lm.abstract_params``): shapes and dtypes only, nothing
allocated, ``init_params`` never runs. The state is laid out as DTensors
(of meta local shards) by ``ShardingRules`` and the step runs as the
card would run it, eagerly, on rank 0's shards. (Meta, not
``FakeTensorMode``: under it DTensor's sizing of a strided shard, which
a matmul over a (batch, sequence)-sharded activation needs, calls
``tolist()`` on a fake tensor and fails, in torch 2.13.) One dispatch
mode (:class:`DeviceCosts`) sees rank 0's local operations and
collectives and counts

  * FLOPs by ``torch.utils.flop_counter``'s formulas (its
    ``flop_registry``, the formulas of ``FlopCounterMode``), on each
    local operation: ``FlopCounterMode`` itself counts a DTensor
    operation's global FLOPs;
  * bytes accessed: each non-view operation's tensor inputs read once and
    outputs written once;
  * memory: the live bytes of every storage the step creates (freed
    when its last tensor dies), on top of the arguments' shard bytes;
    ``peak_bytes`` is the largest sum, eager PyTorch's peak without the
    allocator's caching, and ``peak_top`` the largest storages live at
    it, each with the op that made it;
  * collectives: ``dist.comm.CollectiveLogger``'s log (DTensor's
    choices, not XLA's), and ``wire_by_op`` their wire bytes by the
    DTensor op that issued them.

``launch/peak_check.py`` holds the memory estimate of a train step
(:func:`trace_train_step`) against the cards' measured peak on a split
mesh.

Attention runs through the abstract kernel backend (``abstract``,
registered here and selected nowhere else): its forward returns an
empty tensor and adds the hand-written kernel's FLOPs (4·dh per kept
(q, k) pair) and bytes (q, k, v read, the output written); its backward
is the registry's plain-version VJP, so the trace charges the (B, Hq,
S, S) float32 recompute the card pays.

As in the reference, costs come from the unrolled model at depths 2p and
4p (p the block pattern's period), extrapolated linearly to the full
depth (every per-layer quantity is linear in depth), or from the model
itself when it is no deeper than 4p and for decode shapes; memory comes
from a full-depth trace of the scanned variant (``lm.forward_scanned``
over stacked parameters), or of the model itself when costs are exact.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
import weakref

import numpy as np
import torch

from repro_torch.configs.registry import (ARCHS, SHAPES, ShapeSpec,
                                          get_config, shape_applicable)
from repro_torch.dist.comm import CollectiveLogger
from repro_torch.dist.shardings import ShardingRules
from repro_torch.kernels import ref, registry
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, \
    make_production_mesh
from repro_torch.models import lm
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (abstract_train_state,
                                             make_train_step,
                                             train_state_axes)

METHOD = ("meta-tensor trace of rank 0 on a fake process group; FLOPs by "
          "torch.utils.flop_counter formulas on local ops; memory = live "
          "storage bytes (eager, no allocator cache); collectives logged "
          "by dist.comm.CollectiveLogger; attention by the abstract kernel "
          "backend (plain-version backward)")
PEAK_TOP = 8   # the storages a record lists at its peak
# ops whose result aliases their input on a card, though their meta
# kernel makes a new tensor (torch 2.13 wraps a collective's result so)
_ALIASES = {"_wrap_tensor_autograd"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class DeviceCosts(CollectiveLogger):
    """FLOPs, bytes accessed, live and peak memory and collectives of the
    local operations (one rank's) run under it; see the module
    docstring. :meth:`peak_storages` names the largest storages live at
    the peak: the local op that made each, its shape and dtype, the
    DTensor op it ran for and, for one of 16 MiB or more, the model's
    line that called it."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        # (storage key, bytes, label) when made, (key, None, None) when
        # freed; the first _peak_at of them hold the peak's live set
        self._events: list[tuple] = []
        self._peak_at = 0
        self._dtensor_op = ""
        # the DTensor op (and model line) that issued them -> wire bytes
        self.wire_by_op: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = func._overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _collective(self, func, args, out) -> None:
        n = len(self.log.entries)
        super()._collective(func, args, out)
        key = self._dtensor_op + _model_line()
        for e in self.log.entries[n:]:
            self.wire_by_op[key] = self.wire_by_op.get(key, 0.0) \
                + e.wire_bytes

    def peak_storages(self, k: int = PEAK_TOP) -> list:
        """The ``k`` largest storages live at the peak, largest first:
        ``[bytes, label]`` each."""
        live: dict[int, tuple] = {}
        for key, nbytes, label in self._events[:self._peak_at]:
            if nbytes is None:
                del live[key]
            else:
                live[key] = (nbytes, label)
        return [list(x) for x in sorted(live.values(), key=lambda x: -x[0])
                [:k]]

    def add_kernel(self, flops: float, nbytes: float) -> None:
        """Charge a kernel the trace cannot run (the abstract backend)."""
        self.flops += flops
        self.bytes_accessed += nbytes

    def track_arguments(self, tree) -> int:
        """Count the local shards of ``tree`` as live (the step's
        arguments); returns their bytes."""
        total = 0
        for t in map(_local, _tensors(tree)):
            total += self._track(t, _nbytes(t), "argument", free=False)
        return total

    def _track(self, t: torch.Tensor, nbytes: int, label, *,
               free: bool = True) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        self._storages[key] = nbytes
        self._events.append((key, nbytes, label))
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live
            self._peak_at = len(self._events)
        if free:
            weakref.finalize(st, self._free, key)
        return nbytes

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)
        self._events.append((key, None, None))

    def on_local(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if func.is_view or packet.__name__ in _ALIASES:
            return
        if packet.__name__ not in _NO_TRAFFIC:
            self.bytes_accessed += sum(map(_nbytes, _tensors(list(args))))
            self.bytes_accessed += sum(map(_nbytes, outs))
        for t in outs:
            nbytes = t.untyped_storage().nbytes()
            label = (f"{packet.__name__} {tuple(t.shape)} "
                     f"{str(t.dtype)[6:]} for {self._dtensor_op}"
                     + (_model_line() if nbytes >= 1 << 24 else ""))
            self._track(t, nbytes, label)


def _model_line() -> str:
    """`` at file:line (function)`` of the innermost caller in the
    model's own modules (``models/``, ``nn/``) or their DTensor versions
    (``dist/sharded_ops.py``), past ``nn.layers.shardable``'s wrapper, or
    ``""`` (the backward, outside a recompute)."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if ("/repro_torch/models/" in path or "/repro_torch/nn/" in path
                or path.endswith("/repro_torch/dist/sharded_ops.py")) \
                and f.f_code.co_name != "call":
            return (f" at {'/'.join(path.split('/')[-2:])}:{f.f_lineno} "
                    f"({f.f_code.co_name})")
        f = f.f_back
    return ""


def attention_pairs(sq: int, skv: int, window: int | None = None) -> int:
    """(q, k) pairs a causal mask keeps: row i sees keys 0 .. Skv - Sq + i,
    and with a window only the last ``window`` of them."""
    seen = np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv)
    if window is not None:
        seen = np.minimum(seen, window)
    return int(seen.sum())


class AbstractBackend(registry.ReferenceBackend):
    """The dry-run's kernel backend: attention charges the hand-written
    kernel's work to :attr:`costs` and returns an empty tensor; its
    backward is the plain version's VJP (the cuda backend's). Every
    other op is the plain version."""

    name = "abstract"

    def __init__(self):
        self.costs: DeviceCosts | None = None

    def attention(self, q, k, v, *, causal=True, window=None, scale=None):
        def kernel(q, k, v):
            b, hq, sq, dh = q.shape
            pairs = attention_pairs(sq, k.shape[2], window) if causal \
                else sq * k.shape[2]
            self.costs.add_kernel(4.0 * dh * pairs * b * hq,
                                  2 * _nbytes(q) + _nbytes(k) + _nbytes(v))
            return torch.empty_like(q)

        return registry._with_plain_vjp(
            kernel, lambda q, k, v: ref.flash_attention(
                q, k, v, causal=causal, scale=scale, window=window),
            q, k, v)


def _reduced(cfg, k: int):
    return dataclasses.replace(cfg, n_layers=k, block_pattern=cfg.pattern[:k])


def _cost_depths(cfg) -> tuple[int, int] | None:
    p = lm.pattern_period(cfg)
    l1, l2 = 2 * p, 4 * p
    if cfg.n_layers <= l2:
        return None
    return l1, l2


def _f32(tree):
    """Float32 meta tensors of ``tree``'s shapes (AdamW's moments)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_f32(v) for v in tree)
    return torch.empty(tree.shape, dtype=torch.float32, device="meta")


def _decode_batch(specs: dict, shape) -> dict:
    """A decode batch's ``pos`` as the int the step reads (the last
    position of the cache)."""
    return dict(specs, pos=shape.seq_len - 1)


def _build_step(cfg, shape, rules, backend, *, scanned: bool = False):
    """(fn, args, axes) of one step: ``fn(*args)`` with ``args`` the
    abstract trees (meta tensors) and ``axes`` their logical axes."""
    specs, b_axes = input_specs(cfg, shape)
    if scanned:
        params, p_axes = lm.scanned_abstract_params(cfg)
    else:
        params, p_axes = lm.abstract_params(cfg), lm.param_axes(cfg)
    if shape.kind == "train":
        if scanned:
            m = _f32(params)
            opt = dict(abstract_train_state(cfg)[1], m=m, v=m)
            o_axes = dict(train_state_axes(cfg)[1], m=p_axes, v=p_axes)
        else:
            opt, o_axes = abstract_train_state(cfg)[1], train_state_axes(
                cfg)[1]
        step = make_train_step(
            cfg, AdamWConfig(), rules, remat=True, backend=backend,
            donate=True,
            loss_fn=lm.loss_fn_scanned if scanned else lm.loss_fn)
        return step, (params, opt, specs), (p_axes, o_axes, b_axes)
    if shape.kind == "prefill":
        if scanned:   # the proof of a prefill: the full-sequence forward
            def fn(params, batch):
                return lm.forward_scanned(params, cfg, batch,
                                          constrain=rules.constrain,
                                          backend=backend)
        else:
            def fn(params, batch):
                return lm.prefill(params, cfg, batch, shape.seq_len,
                                  constrain=rules.constrain, backend=backend)
        return fn, (params, specs), (p_axes, b_axes)
    caches = lm.cache_struct(cfg, shape.global_batch, shape.seq_len,
                             abstract=True)

    def fn(params, batch, caches):
        return lm.decode_step(params, cfg, _decode_batch(batch, shape),
                              caches, constrain=rules.constrain)

    del b_axes["pos"]
    specs = {k: v for k, v in specs.items() if k != "pos"}
    return fn, (params, specs, caches), (p_axes, b_axes, lm.cache_axes(cfg))


def _materialize(tree, rules, axes):
    """The abstract (meta) ``tree`` laid out by ``rules``: DTensors of
    meta shards. A scalar (the optimizer's step) stays a plain tensor."""
    def one(t, ax):
        return t if t.dim() == 0 else rules.distribute(t, ax)

    if isinstance(tree, dict):
        return {k: _materialize(v, rules, axes[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, rules, a)
                          for v, a in zip(tree, axes))
    return one(tree, axes)


def trace_once(fn, args, axes, rules, backend: AbstractBackend) -> dict:
    """One meta-tensor run of ``fn`` on rank 0: its costs and memory."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    dargs = _materialize(args, rules, axes)
    costs = DeviceCosts(rules.mesh)
    arg_bytes = costs.track_arguments(dargs)
    arg_storages = {id(_local(t).untyped_storage()) for t in _tensors(dargs)}
    backend.costs = costs
    try:
        with costs, implicit_replication():
            out = fn(*dargs)
    finally:
        backend.costs = None
    outs = [_local(t) for t in _tensors(out)]
    out_bytes = sum(map(_nbytes, outs))
    alias = sum(_nbytes(t) for t in outs
                if id(t.untyped_storage()) in arg_storages)
    peak = costs.peak
    stats = costs.log.stats()
    return {
        "trace_s": round(time.time() - t0, 2),
        "flops_per_device": float(costs.flops),
        "bytes_accessed_per_device": float(costs.bytes_accessed),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "alias_bytes": alias,
                   "peak_bytes": peak, "peak_top": costs.peak_storages()},
        "collectives": {"operand_bytes": stats.operand_bytes,
                        "wire_bytes": stats.wire_bytes,
                        "counts": stats.counts,
                        "total_wire_bytes": stats.total_wire_bytes},
        "wire_by_op": dict(sorted(costs.wire_by_op.items(),
                                  key=lambda kv: -kv[1])[:PEAK_TOP]),
    }


def trace_train_step(cfg, mesh_shape: tuple, batch: int, seq: int) -> dict:
    """:func:`trace_once` of one train step of ``cfg`` on ``batch`` x
    ``seq`` tokens (remat, donating) on a fake ``("data", "model")`` mesh
    of ``mesh_shape``: the estimate that ``chip_smoke.py``'s phase 7b and
    ``launch/peak_check.py`` hold against the cards. Makes the fake
    process group and tears it down."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _fake_group(math.prod(mesh_shape))
    try:
        rules = ShardingRules(init_device_mesh(
            "cpu", mesh_shape, mesh_dim_names=("data", "model")))
        backend = _backend()
        return trace_once(*_build_step(
            cfg, ShapeSpec("train_step", seq, batch, "train"), rules,
            backend), rules, backend)
    finally:
        dist.destroy_process_group()


def _extrapolate(p1: dict, p2: dict, l1: int, l2: int, L: int) -> dict:
    def ext(v1, v2):
        return v2 + (L - l2) * (v2 - v1) / (l2 - l1)

    out = {
        "flops_per_device": ext(p1["flops_per_device"],
                                p2["flops_per_device"]),
        "bytes_accessed_per_device": ext(p1["bytes_accessed_per_device"],
                                         p2["bytes_accessed_per_device"]),
    }
    coll = {"operand_bytes": {}, "wire_bytes": {}, "counts": {}}
    ops = set(p1["collectives"]["wire_bytes"]) \
        | set(p2["collectives"]["wire_bytes"])
    for kind in ("operand_bytes", "wire_bytes", "counts"):
        for op in ops:
            v1 = p1["collectives"][kind].get(op, 0)
            v2 = p2["collectives"][kind].get(op, 0)
            coll[kind][op] = max(0.0, ext(v1, v2))
    coll["total_wire_bytes"] = sum(coll["wire_bytes"].values())
    out["collectives"] = coll
    return out


def _backend() -> AbstractBackend:
    """The abstract backend, registered under its name (the registry
    keeps one per name, so each call replaces the last)."""
    return registry.register_backend(AbstractBackend())


def run_cell(arch: str, shape_name: str, mesh_kind: str, mesh,
             out_dir: pathlib.Path, overrides: dict | None = None, *,
             verbose: bool = True, tag: str = "",
             skip_proof: bool = False) -> dict:
    """One cell's record (also written to ``out_dir``), traced on
    ``mesh``, the ``DeviceMesh`` of ``mesh_kind``."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = shape_applicable(arch, shape_name)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind, "tag": tag,
        "params_total": cfg.num_params(),
        "params_active": cfg.active_params(),
        "n_layers": cfg.n_layers, "method": METHOD,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        fname.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[skip] {arch} × {shape_name}: {why}", flush=True)
        return rec

    try:
        rules = ShardingRules(mesh)
        if overrides:
            rules = rules.override(**overrides)
        rec["devices"] = int(math.prod(mesh.shape))
        backend = _backend()

        def trace(c, scanned=False):
            return trace_once(*_build_step(c, shape, rules, backend,
                                           scanned=scanned),
                              rules, backend)

        depths = None if shape.kind == "decode" else _cost_depths(cfg)
        if depths is None:
            res = trace(cfg)
            rec["proof"] = {"mode": "exact", "n_layers": cfg.n_layers,
                            "trace_s": res["trace_s"],
                            "memory": res["memory"]}
            rec["costs"] = {"mode": "exact", **{k: v for k, v in res.items()
                                                if k != "memory"}}
        else:
            l1, l2 = depths
            r1 = trace(_reduced(cfg, l1))
            r2 = trace(_reduced(cfg, l2))
            rec["costs"] = {
                "mode": "extrapolated", "l1": l1, "l2": l2,
                **_extrapolate(r1, r2, l1, l2, cfg.n_layers),
                "points": {str(l1): r1, str(l2): r2},
            }
            if skip_proof:
                rec["proof"] = {"mode": "skipped"}
            else:
                pres = trace(cfg, scanned=True)
                rec["proof"] = {"mode": "scanned-full-depth",
                                "n_layers": cfg.n_layers,
                                "trace_s": pres["trace_s"],
                                "memory": pres["memory"]}
        rec["status"] = "ok"
        if verbose:
            print(summary(rec), flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[ERR] {arch} × {shape_name} × {mesh_kind}: "
                  f"{rec['error']}", flush=True)
    fname.write_text(json.dumps(rec, indent=2))
    return rec


def mem_per_device(rec: dict) -> float:
    """A record's per-device peak in bytes (0 without a proof)."""
    return rec["proof"].get("memory", {}).get("peak_bytes", 0)


def summary(rec: dict) -> str:
    """The one-line summary of an ``ok`` record."""
    c = rec["costs"]
    return (f"[ok]  {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:6s} "
            f"flops/dev={c['flops_per_device']:.3e} "
            f"coll={c['collectives']['total_wire_bytes'] / 2**20:9.1f}MiB "
            f"mem/dev={mem_per_device(rec) / 2**30:6.2f}GiB "
            f"({c.get('mode', '?')[:5]}/{rec['proof'].get('mode', '?')[:7]})")


def _fake_group(world: int) -> None:
    """A process group of ``world`` fake ranks (this process is rank 0;
    collectives return at once and move nothing)."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--skip-proof", action="store_true",
                    help="skip the full-depth scanned memory trace "
                         "(hillclimb iterations only need costs)")
    ap.add_argument("--override", action="append", default=[],
                    help="sharding rule override: logical=mesh1[+mesh2] or "
                         "logical= (empty => unsharded)")
    return ap


def main(argv=None) -> None:
    import torch.distributed as dist

    args = parser().parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        if not v:
            overrides[k] = ()
        else:
            overrides[k] = tuple(
                tuple(p.split("+")) if "+" in p else p for p in v.split(","))

    out_dir = pathlib.Path(args.out)
    t0 = time.time()
    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        shape_, _ = MULTI_POD if mesh_kind == "multi" else SINGLE_POD
        _fake_group(math.prod(shape_))
        try:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                        device_type="cpu")
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mesh_kind, mesh, out_dir,
                                   overrides or None, tag=args.tag,
                                   skip_proof=args.skip_proof)
                    s = rec["status"]
                    n_ok += s == "ok"
                    n_skip += s == "skipped"
                    n_err += s == "error"
        finally:
            dist.destroy_process_group()
    print(f"\ndone in {time.time() - t0:.0f}s: {n_ok} ok, {n_skip} skipped, "
          f"{n_err} errors", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
