#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it,
and fails (non-zero exit, no result line) without them. In order:

1. device check: prints ``nvidia-smi``'s name and power limit; TF32 off;
2. build: compiles ``src/repro_torch/kernels/csrc`` for sm_90a and prints
   the ``-Xptxas -v`` report (registers, shared memory, spills);
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's full-scale Pubmed shapes (atol = rtol = 1e-4 for the
   float32 products, exact for max, 1e-5 for sum), timed with CUDA events
   beside the plain version, one PyTorch library call and the card's bound;
4. serve phase: GNNServeEngine + Server over full-scale Pubmed with gcn,
   sage_mean and sage_max (hidden 16, 2 layers); every kernel's launch
   count must rise; each model's full-graph logits must match the same
   model on the ``reference`` backend within 1e-4;
5. summary: a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

No phase catches its own failure: any failure raises.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# One H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# and HBM3. A card capped below 700 W runs slower than these.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ARCHS = ("gcn", "sage_mean", "sage_max")
REPLACES = {
    "shard_spmm": "src/repro/kernels/shard_spmm.py:69",
    "fused_gnn": "src/repro/kernels/fused_gnn.py:88",
    "dense_engine": "src/repro/kernels/dense_engine.py:87",
    "seg_gather": "src/repro/kernels/seg_gather.py:78",
}


def _ms(fn, budget_ms: float = 300.0) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around a run of
    launches, after a warm-up call; the count fits ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(100, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_check() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return card


def build(lib) -> None:
    t0 = time.perf_counter()
    so = lib.build()
    lib.lib()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s "
          f"(sm_90a, from {lib.CSRC.relative_to(ROOT)})")
    for line in lib.build_log().splitlines():
        if line.startswith("==") or "ptxas info" in line \
                or "spill" in line:
            print(f"  {line.strip()}")


def kernel_phase(engine, ds) -> dict:
    """Each kernel against its plain version at the Pubmed shapes."""
    from repro_torch.kernels import dense_engine, fused_gnn, ref, seg_gather
    from repro_torch.kernels import shard_spmm

    dev = engine.device
    gts = {a: engine.executable(f"{a}@pubmed", "pubmed").gt for a in ARCHS}
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    h = gts["gcn"].group(torch.from_numpy(ds.features).to(dev))  # (39, 512, 500)
    s, n, d = h.shape
    rows = s * n
    results = {}

    def record(name, out, plain, kernel_fn, plain_fn, library_fn,
               nbytes, flops, **extra):
        err = (out - plain).abs().max().item()
        bound, by = _bound(nbytes, flops)
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": err, "ms": _ms(kernel_fn),
               "plain_ms": _ms(plain_fn), "bound_ms": bound,
               "bound_by": by,
               "library_ms": _ms(library_fn) if library_fn else None,
               **extra}
        results[name] = row
        print(f"kernel {name}: max_abs_err {err:.3e} | kernel_ms "
              f"{row['ms']:.3f} plain_ms {row['plain_ms']:.3f} library_ms "
              f"{row['library_ms']:.3f} bound_ms {bound:.3f} ({by}) "
              f"{extra or ''}")

    # shard_spmm: sage_mean's mean-normalized blocks, layer-0 features
    blocks = gts["sage_mean"].blocks                              # (39, 39, 512, 512)
    nnz = int((blocks != 0).sum().item())
    out = shard_spmm.shard_spmm(blocks, h)
    plain = ref.shard_spmm(blocks, h)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    dense_flops = 2.0 * s * s * n * n * d
    record("shard_spmm", out, plain,
           lambda: shard_spmm.shard_spmm(blocks, h),
           lambda: ref.shard_spmm(blocks, h),
           lambda: torch.einsum("ijvu,jud->ivd", blocks, h),
           _nbytes(blocks, h, out), 2.0 * nnz * d,
           nnz=nnz, dense_ops_bound_ms=dense_flops / PEAK_F32_FLOPS * 1e3)

    # fused_gnn: gcn's normalized blocks, w (500, 16), relu
    gblocks = gts["gcn"].blocks
    gnnz = int((gblocks != 0).sum().item())
    w = randn(d, 16, scale=(2.0 / (d + 16)) ** 0.5)
    out = fused_gnn.fused_gnn_layer(gblocks, h, w, activation="relu")
    plain = ref.fused_gnn(gblocks, h, w, activation="relu")
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    record("fused_gnn", out, plain,
           lambda: fused_gnn.fused_gnn_layer(gblocks, h, w, activation="relu"),
           lambda: ref.fused_gnn(gblocks, h, w, activation="relu"),
           lambda: torch.relu(torch.einsum(
               "ivd,df->ivf", torch.einsum("ijvu,jud->ivd", gblocks, h), w)),
           _nbytes(gblocks, h, w, out), 2.0 * gnnz * d + 2.0 * rows * d * 16,
           nnz=gnnz,
           dense_ops_bound_ms=(2.0 * s * s * n * n * d + 2.0 * rows * d * 16)
           / PEAK_F32_FLOPS * 1e3)

    # dense_engine: sage_max's pool transform (relu) and its concat product
    x = h.reshape(rows, d)
    wp = randn(d, d, scale=(1.0 / d) ** 0.5)
    bp = randn(d, scale=0.1)
    x2 = randn(rows, 2 * d)
    w2 = randn(2 * d, 16, scale=(1.0 / (2 * d)) ** 0.5)
    out = dense_engine.dense_engine_matmul(x, wp, bp, activation="relu")
    plain = ref.dense_engine(x, wp, bp, activation="relu")
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    out2 = dense_engine.dense_engine_matmul(x2, w2)
    plain2 = ref.dense_engine(x2, w2)
    torch.testing.assert_close(out2, plain2, atol=1e-4, rtol=1e-4)
    second_ms = _ms(lambda: dense_engine.dense_engine_matmul(x2, w2))
    second_bound, _ = _bound(_nbytes(x2, w2, out2), 2.0 * rows * 2 * d * 16)
    record("dense_engine", out, plain,
           lambda: dense_engine.dense_engine_matmul(x, wp, bp,
                                                    activation="relu"),
           lambda: ref.dense_engine(x, wp, bp, activation="relu"),
           lambda: torch.relu(torch.addmm(bp, x, wp)),
           _nbytes(x, wp, bp, out), 2.0 * rows * d * d,
           concat_product={"shape": [rows, 2 * d, 16], "ms": second_ms,
                           "bound_ms": second_bound,
                           "max_abs_err": (out2 - plain2).abs().max().item()})

    # seg_gather: sage_max's edge lists; max must be exact, sum within 1e-5
    gt = gts["sage_max"]
    z = torch.relu(x @ wp + bp).reshape(s, n, d)
    out = seg_gather.seg_gather_aggregate(gt.edge_src, gt.edge_dst,
                                          gt.edge_valid, z, op="max")
    plain = ref.seg_gather(gt.edge_src, gt.edge_dst, gt.edge_valid, z,
                           op="max")
    if not torch.equal(out, plain):
        raise AssertionError(
            f"seg_gather max differs from its plain version: max abs err "
            f"{(out - plain).abs().max().item():.3e}")
    out_sum = seg_gather.seg_gather_aggregate(gt.edge_src, gt.edge_dst,
                                              gt.edge_valid, z, op="sum")
    plain_sum = ref.seg_gather(gt.edge_src, gt.edge_dst, gt.edge_valid, z,
                               op="sum")
    torch.testing.assert_close(out_sum, plain_sum, atol=1e-5, rtol=1e-5)
    valid = int(gt.edge_valid.sum().item())

    def library():
        # the whole function from the same inputs: valid slots -> global
        # ids, gather of the source rows, one scatter_reduce, empty -> 0
        ii, jj, ee = gt.edge_valid.nonzero(as_tuple=True)
        dst = (ii * n + gt.edge_dst[ii, jj, ee].long())[:, None].expand(-1, d)
        src_rows = z.reshape(-1, d).index_select(
            0, jj * n + gt.edge_src[ii, jj, ee].long())
        acc = torch.full((rows, d), float("-inf"), device=dev).scatter_reduce_(
            0, dst, src_rows, reduce="amax", include_self=True)
        return torch.where(torch.isfinite(acc), acc, 0.0)

    record("seg_gather", out, plain,
           lambda: seg_gather.seg_gather_aggregate(
               gt.edge_src, gt.edge_dst, gt.edge_valid, z, op="max"),
           lambda: ref.seg_gather(gt.edge_src, gt.edge_dst, gt.edge_valid,
                                  z, op="max"),
           library,
           _nbytes(gt.edge_src, gt.edge_dst, gt.edge_valid, z, out),
           float(valid * d),
           valid_edges=valid, edge_slots=int(gt.edge_valid.numel()),
           sum_max_abs_err=(out_sum - plain_sum).abs().max().item())
    return results


def serve_phase(engine, ds, args) -> dict:
    """Drive the engine through the Server; return the launch counts."""
    from repro_torch import runtime
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import drive, latency_percentiles
    from repro_torch.serving import Completed

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    server, outcomes = drive(engine, {"pubmed": ds}, list(ARCHS), args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _lib.launches()
    done = sum(isinstance(o, Completed) for o in outcomes)
    p50, p95, p99 = latency_percentiles(outcomes)
    print(server.report())
    print(engine.cache_report())
    print(f"serve: {done}/{len(outcomes)} requests in {wall:.3f} s | "
          f"latency p50 {p50:.3f} ms, p95 {p95:.3f} ms, p99 {p99:.3f} ms")
    print(f"serve: kernel launches {launches}")
    if done != len(outcomes):
        raise AssertionError(f"only {done}/{len(outcomes)} requests completed")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    for arch in ARCHS:
        exe = engine.executable(f"{arch}@pubmed", "pubmed")
        logits = exe.forward()
        ref_exe = runtime.compile(
            exe.spec, ds, backend="reference", params=exe.params,
            max_shard_n=engine.max_shard_n, store=engine.store,
            graph_key="pubmed")
        expect = ref_exe.forward()
        err = (logits - expect).abs().max().item()
        torch.testing.assert_close(logits, expect, atol=1e-4, rtol=1e-4)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{arch}: non-finite logits")

        def fwd():
            exe.forward()
            torch.cuda.synchronize()

        fwd()
        t0 = time.perf_counter()
        for _ in range(3):
            fwd()
        fwd_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"parity {arch}: logits {tuple(logits.shape)} vs reference "
              f"backend max_abs_err {err:.3e} | full-graph forward "
              f"{fwd_ms:.3f} ms (host clock, synchronized)")
    return launches


def main() -> None:
    device_check()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_engine, parser

    build(_lib)
    args = parser().parse_args(
        ["--graphs", "pubmed", "--models", ",".join(ARCHS), "--scale", "1.0",
         "--hidden", "16", "--layers", "2", "--shard-n", "512",
         "--num-requests", "48"])
    t0 = time.perf_counter()
    engine, datasets = build_engine(args)
    ds = datasets["pubmed"]
    print(f"setup: engine + Pubmed in {time.perf_counter() - t0:.1f} s")
    kernels = kernel_phase(engine, ds)
    launches = serve_phase(engine, ds, args)
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
