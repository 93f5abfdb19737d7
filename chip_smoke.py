#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it,
and fails (non-zero exit, no result line) without them. Device memory:
~6.4 GB of Pubmed block grids for serving and as much again for training
(the stream phase: as much for its engine, a transient clone per patch
and a fresh build to compare with), then (after they are freed) 16.4 GB of qwen3-8b weights plus ~1.2 GB of
KV cache and a few GB of plain-attention scratch. In order:

1. device check: prints ``nvidia-smi``'s name and power limit; TF32 off;
2. build: compiles ``src/repro_torch/kernels/csrc`` for sm_90a and prints
   the ``-Xptxas -v`` report (registers, shared memory, spills);
3. GNN kernel phase: each GNN kernel against its plain PyTorch version on
   the card at the GNN path's full-scale Pubmed shapes (atol = rtol = 1e-4
   for the float32 products, exact for max, 1e-5 for sum), timed with
   CUDA events beside the plain version, one PyTorch library call and the
   card's bound; shard_spmm (both layers' shapes and a rectangular grid),
   fused_gnn (both layers' shapes) and seg_gather are timed as the serve
   path calls them (shard_spmm also over gat's kept index with one
   head's attention weights as its values, at D 8 and D 3) (with the graph's kept index) and standalone (index
   built in the call), each index build alone, and the library path with
   its index kept (shard_spmm and fused_gnn: a cuSPARSE CSR product over
   the same index, the dense einsum beside it); dense_engine (3xTF32) is also held
   to the float64 product (relative norm ``DENSE_REL``) at both Pubmed
   shapes;
4. GNN serve phase: GNNServeEngine + Server over full-scale Pubmed with
   gcn, sage_mean, sage_max, gin and gat (hidden 16, 2 layers, gat 2
   heads); each GNN kernel must launch as often as ``GNN_LAUNCHES`` says,
   and each model's forward as ``FORWARD_LAUNCHES`` says; each model's
   full-graph logits must match the same model on the ``reference``
   backend within 1e-4;
4b. GNN train phase, full-batch, each arch on full-scale Pubmed: the
   step-0 gradient of every parameter through the kernels must be within
   ``GRAD_REL`` (relative norm) of the ``reference`` backend's; one train
   step must launch exactly its forward's kernels; ``runtime.fit`` runs
   ``TRAIN_STEPS`` steps at lr 1e-2 and the last loss must be below the
   first; the trained executable's logits must equal a fresh
   ``runtime.compile`` with the trained parameters; the median step,
   forward, backward and update times are printed, and one step is
   traced with ``torch.profiler`` (kernel time by name, idle share);
4c. GNN train phase, mini-batch: gcn with ``MB_BATCH_NODES`` seeds and
   fanout ``MB_FANOUT`` for ``MB_STEPS`` steps; the step time and its
   host part (sample + shard + upload, and the index build) are printed;
4d. GNN stream phase, full-scale Pubmed (its own engine, freed before
   the LM phases): ``GNNServeEngine(streaming=True, edge_slack=0.25,
   invalidation="targeted")`` with the five archs behind a Server (max
   batch ``STREAM_BATCH``); ``STREAM_DELTAS`` deltas from
   ``random_delta`` (seed 0), one request per model before each, and a
   gcn ``StreamTrainer`` round every ``STREAM_FINETUNE_EVERY`` deltas.
   Every ticket must complete, with no recompile, no patch rebuild and
   no trainer rebuild; after one more (measured) delta each arch's
   served logits must equal a fresh cuda compile of the post-delta graph
   bitwise, be within 1e-4 of the ``reference`` backend, launch exactly
   ``FORWARD_LAUNCHES``, and a request for that delta's affected nodes
   must return the fresh compile's classes; a last delta that adds more
   nodes than the template has left must compact (``rebuilt``), every
   served executable must recompile lazily, and the bitwise check must
   hold again. Printed: mutate time (host patch, device update), index
   rebuild per signature, cold request and warm forward per arch, rows
   invalidated per delta, request latency, trainer rounds, compaction;
4e. GNN tune phase, full-scale Pubmed (its own engine, freed before the
   LM phases): ``env.pin_for_benchmarks()`` and its ``describe()``
   printed; ``GNNServeEngine(plan="autotune", tune_budget=TUNE_BUDGET,
   max_shard_n=TUNE_MAX_SHARD_N)`` serves the five archs behind a Server,
   winners memoized in a temporary ``REPRO_PLAN_CACHE``. Every arch's
   compile must be ``autotune`` with no failed candidate; its logits
   within 1e-4 of the ``reference`` backend, bitwise equal to an analytic
   ``cuda`` compile where both run the same program (``executed_digest``),
   and a forward must launch what the winner's fused flags say
   (``_plan_launches``). A second compile of each pair must measure
   nothing, and after ``clear_tune_cache()`` each must load from disk.
   ``runtime.fit(plan="autotune")`` trains gcn ``TUNE_FIT_STEPS`` steps:
   the loss falls and a step launches exactly its forward's kernels.
   Printed: each arch's measured/pruned counts, winner and analytic ms
   and speedup; the host build per signature; the phase's wall time and
   peak device memory;
4f. GNN mesh phase, full-scale Pubmed (its own engines, freed before the
   LM phases): the sharded program (``dist/gnn.py``) on a ``LocalMesh``
   of data 4 x model 2 ranks on the one card (``make_mesh_for(8,
   model_parallel=2)``; S 39 padded to 40). The main path: 16 requests
   over gcn, sage_mean and gin through a Server on
   ``GNNServeEngine(mesh=...)``, each answer equal to a single-device
   engine's. For each arch, contiguous and fennel (hub cache 256): logits
   within 1e-4 of the single-device cuda Executable and of the sharded
   ``reference`` backend, ``verify_comm()``, the counted wire bytes equal
   ``MESH_ALLGATHER`` / ``MESH_ALLREDUCE`` exactly, a forward launches
   ``MESH_LAUNCHES`` exactly; sage_max and gat raise
   ``NotImplementedError``. shard_spmm over data group 0's local grid
   with its kept index at D 250 and dense_engine at (5120, 250) @ (250,
   16) against their plain versions, timed beside their bounds and a
   library call (``mesh_local`` on the kernels line). gcn trains
   ``MESH_TRAIN_STEPS`` steps on the mesh: step-0 gradients within
   ``GRAD_REL`` of single-device, ``verify_train_comm()``. A mutable
   fennel engine and a mutable contiguous one take ``MESH_DELTAS`` deltas
   each through ``Server.mutate`` in template; fennel's logits within
   1e-4 of a fresh single-device compile, contiguous's bitwise equal to a
   fresh sharded compile. Printed: the sharded forward's median ms, the
   partition's host ms, mutate times, the phase's wall time and peak
   device memory. Eight ranks run their kernels in turn on the one card:
   the times say nothing about scaling;
4g. GNN analyze phase, full-scale Pubmed (its own engines, freed before
   the LM phases): ``repro_torch.analyze`` through the kernels. The main
   path: each of the five archs compiled ``mutable_graph=True`` with
   ``analyze="error"``, then ``analyze_executable(exe, probe=True,
   graph=ds)`` (the dtype recorder's forward, two more forwards, a
   delete-and-reinsert delta pair through ``update_graph``, five node
   batches) with no error finding; the probe's kernel launches equal its
   forwards x ``FORWARD_LAUNCHES`` exactly and its index builds are at
   most one of each kind per ``GraphTensors`` it ran on. Three negative
   controls must fire: DT001 on a forward that calls ``.double()``
   outside ``allow_f64``, RT003 on a frozen (``mutable_graph=False``) gcn
   given an insert into its fullest shard pair, LS001 on two sanitized
   locks taken in both orders. Then, under ``lock_sanitizer.sanitize()``:
   a streaming ``GNNServeEngine`` with the five archs, each served once,
   ``Server.start(analyze="error")``, one more request per arch, 10
   deltas through ``Server.mutate`` with requests in flight; every
   request completes and no LS001 (each LS002 is printed with its hold).
   Last, ``launch.analyze.main(["--fail-on", "error", "--backend",
   "cuda"])`` returns 0. Printed: findings by rule and pass, the probes'
   ``timings_ms``, the dtype recorder's forward beside the plain one,
   the phase's wall time and peak device memory;
5. attention kernel phase: flash_attention's two kernels against the
   plain version: the tensor-core kernel (the bf16 route) at the LM
   path's prefill shapes (B 4, Hq 32, Hkv 8, S 1024 and 2048, dh 128,
   causal), at an Sq < Skv shape and at a ragged S 2000 (8e-2 max abs,
   5e-3 relative norm); the CUDA-core kernel (the float32 route) at S
   2048 and Sq < Skv (2e-4, 1e-5), and on the bf16 inputs it is timed on
   (8e-2, 5e-3). Both kernels, the CUDA-core one also on the bf16
   inputs, are timed beside the plain version and
   ``scaled_dot_product_attention`` at both prompt lengths;
6. LM serve phase: qwen3-8b at full width (bf16, random weights from a
   seed) behind the Server (max batch 4): 4 requests with 1024-token and 4
   with 2048-token prompts, 16 new tokens each, greedy; all must complete,
   the tensor-core flash_attention kernel must launch once per layer per
   prefill batch (and the CUDA-core one never), and one
   batch's prefill logits must match the ``reference`` backend within
   ``LM_LOGIT_ATOL``; each batch's prefill is timed on both backends, and
   one prefill and one decode step are traced with ``torch.profiler``
   (kernel time, launches, idle share);
7. summary: a ``kernels`` JSON line (each row with its launches in the
   serve run, a train step, the stream run, the tuned serve run, the
   mesh serve run and the analyze phase's probes),
   then the result line
   ``{"ok": true, "device": {...}}`` last.

No phase catches its own failure: any failure raises.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# One H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# dense TF32 and bf16 on the tensor cores, and HBM3. A card capped below 700 W runs
# slower than these.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

ARCHS = ("gcn", "sage_mean", "sage_max", "gin", "gat")
REPLACES = {
    "shard_spmm": "src/repro/kernels/shard_spmm.py:69",
    "fused_gnn": "src/repro/kernels/fused_gnn.py:88",
    "dense_engine": "src/repro/kernels/dense_engine.py:87",
    "seg_gather": "src/repro/kernels/seg_gather.py:78",
    "flash_attention": "src/repro/kernels/flash_attention.py:104",
}

# the LM path: qwen3-8b at full width, 4 requests per prompt length
LM_ARCH = "qwen3-8b"
LM_PROMPTS = (1024, 2048)
LM_REQUESTS_PER_PROMPT = 4
LM_NEW_TOKENS = 16
# cuda vs reference prefill logits (bf16, logits of unit scale): the two
# backends differ only in attention, whose bf16 outputs may differ by one
# rounding (2^-8 relative); such flips pass through 36 bf16 layers.
# Allowed: 0.25 absolute (16 bf16 ulps at |logit| in [2, 4)) and 5e-2 in
# relative norm; an unmasked or misplaced key would be off by O(1).
LM_LOGIT_ATOL = 0.25
LM_LOGIT_REL = 5e-2
# flash_attention against its plain version: max abs (atol = rtol, as the
# reference's own tests) and the relative norm ||out - plain|| / ||plain||.
# A causal row i averages ~i + 1 random values and is ~(i + 1)^-1/2 small,
# so the max-abs limit is set by the first rows and would pass a fault
# that only touches late rows (such as O not rescaled when the running
# max rises); the relative norm weighs every row by its size. bf16: one
# rounding of the output and one of P (as the TPU kernel) each add
# ~2^-9/sqrt(3) relative. The card reads 2.1e-3 to 2.4e-3 at the shapes
# below and 0.40 with O not rescaled by the running max (PERF.md); 5e-3
# sits ~2x above the one and ~80x below the other. float32: 1.1e-6 read.
ATTN_ATOL = {torch.bfloat16: 8e-2, torch.float32: 2e-4}
ATTN_REL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# dense_engine (3xTF32 on the tensor cores) against the float64 product,
# relative norm: float32 accumulation reads ~1e-7 at K = 500-1000, one
# TF32 pass ~3e-4 (PERF.md)
DENSE_REL = 1e-5
# kernel launches of one forward (hidden 16, 2 layers): gcn 2 fused
# layers; sage_mean 2 shard_spmm + 2 dense; sage_max 4 dense (pool and
# concat per layer) + 2 gathers; gin per layer 1 shard_spmm + 2 dense
# (its MLP); gat 1 dense (z = h W) per layer and 1 shard_spmm per head:
# 2 heads on layer 0, 1 on layer 1. A train step launches its forward's
# kernels and no more (the backward is autograd of the plain versions).
FORWARD_LAUNCHES = {
    "gcn": {"fused_gnn": 2},
    "sage_mean": {"shard_spmm": 2, "dense_engine": 2},
    "sage_max": {"dense_engine": 4, "seg_gather": 2},
    "gin": {"shard_spmm": 2, "dense_engine": 4},
    "gat": {"shard_spmm": 3, "dense_engine": 2},
}
# the GNN serve run: one cold forward per model, later requests read the
# cached logits
GNN_LAUNCHES = {k: sum(f.get(k, 0) for f in FORWARD_LAUNCHES.values())
                for k in ("shard_spmm", "fused_gnn", "dense_engine",
                          "seg_gather")}
# step-0 gradients, cuda vs reference backend, relative norm per
# parameter. The backward is the same plain autograd on both sides; the
# forwards differ by the kernels' rounding (3xTF32 products, other
# summation orders: ~1e-7 relative on the logits), which reaches the
# gradients through the saved activations. 1e-4 sits ~100x above that,
# and a wrong kernel (a missed entry, a transposed index) is off by O(1).
GRAD_REL = 1e-4
TRAIN_STEPS = 20
TRAIN_LR = 1e-2
MB_BATCH_NODES = 1024
MB_FANOUT = (10, 5)
MB_STEPS = 4
# the GNN stream phase: a live Pubmed served by every arch while
# STREAM_DELTAS random deltas land (one request of STREAM_NODES nodes per
# model before each) and a StreamTrainer fine-tunes gcn every
# STREAM_FINETUNE_EVERY deltas; then one measured delta, then a delta
# that outgrows the node padding (compaction)
STREAM_DELTAS = 50
STREAM_EDGE_OPS = 8
STREAM_P_NODE = 0.1
STREAM_NODES = 8
STREAM_BATCH = 8
STREAM_FINETUNE_EVERY = 10
STREAM_TRAINER = dict(batch_nodes=32, fanout=(5, 5), steps_per_round=20,
                      lr=1e-2, seed=0)
# the GNN tune phase: every (model, graph) pair tunes at its first
# request, up to TUNE_BUDGET candidate plans on the 1024-node shard grid
# (S 20); TUNE_REQUESTS 8-node requests per model; a tuned gcn fit
TUNE_BUDGET = 8
TUNE_MAX_SHARD_N = 1024
TUNE_REQUESTS = 2
TUNE_FIT_STEPS = 5
# the GNN mesh phase: the sharded program on a LocalMesh of data 4 x
# model 2 ranks on the one card (S 39 padded to S_pad 40, 10 shard rows
# per data group), full-scale Pubmed, hidden 16, 2 layers
MESH_RANKS = 8
MESH_MODEL = 2
MESH_HUB_CACHE = 256
MESH_ARCHS = ("gcn", "sage_mean", "gin")
# kernel launches of one sharded forward: one shard_spmm per rank and
# layer (8 x 2); dense_engine per rank and layer gcn 1, sage_mean 2 (its
# two row-parallel products), gin 2 (its MLP); nothing else
MESH_LAUNCHES = {
    "gcn": {"shard_spmm": 16, "dense_engine": 16},
    "sage_mean": {"shard_spmm": 16, "dense_engine": 32},
    "gin": {"shard_spmm": 16, "dense_engine": 32},
}
# counted wire bytes of one sharded forward, from the reference's
# formulas (dist/gnn.py _layer_allgather_bytes, the psum's 2(g-1)/g B):
# contiguous all-gathers 3 x 40 x 512 x (250 + 8) x 4; fennel 3 x 4 x
# (hub_cap + halo_cap) x 8 x 4 at layer 1 (gcn/sage_mean caps 67 + 4079,
# gin 69 + 4082); the psums 5120 x (16 + 3) x 4 per product
MESH_ALLGATHER = {("contiguous", a): 63_406_080 for a in MESH_ARCHS}
MESH_ALLGATHER.update({("fennel", "gcn"): 1_592_064,
                       ("fennel", "sage_mean"): 1_592_064,
                       ("fennel", "gin"): 1_593_984})
MESH_ALLREDUCE = {"gcn": 389_120, "sage_mean": 389_120, "gin": 778_240}
MESH_REQUESTS = 16
MESH_TRAIN_STEPS = 5
MESH_DELTAS = 5


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


def _host_ms(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` in ms, enqueue only (no sync in the
    loop). Where it exceeds the device time, the card waits on the host
    and ``_ms`` measures this instead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _bound(nbytes: float, flops: float,
           peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _measure(out, plain, kernel_fn, plain_fn, library_fn, nbytes, flops,
             peak_flops=PEAK_F32_FLOPS) -> dict:
    """A kernel's error against its plain version, its time beside the
    plain version's and the library call's, and its bound."""
    bound, by = _bound(nbytes, flops, peak_flops)
    return {"max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "ms": _ms(kernel_fn), "plain_ms": _ms(plain_fn),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _ms(library_fn) if library_fn else None}


def _record(results: dict, name, measured: dict, source=None,
            **extra) -> None:
    """Add a kernel's row of the ``kernels`` line to ``results``."""
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
           "replaces": REPLACES[name], "launches": 0, **measured, **extra}
    results[name] = row
    print(f"kernel {name}: max_abs_err {row['max_abs_err']:.3e} | kernel_ms "
          f"{row['ms']:.3f} plain_ms {row['plain_ms']:.3f} library_ms "
          f"{row['library_ms']:.3f} bound_ms {row['bound_ms']:.3f} "
          f"({row['bound_by']}) {extra or ''}")


def _attention_check(label: str, out, plain, dtype) -> tuple[float, float]:
    """Hold a flash_attention output to its plain version within
    ``ATTN_ATOL`` and ``ATTN_REL``; return (max abs err, relative norm)."""
    got, exp = out.float(), plain.float()
    err = (got - exp).abs().max().item()
    rel = ((got - exp).norm() / exp.norm().clamp_min(1e-30)).item()
    print(f"{label}: max_abs_err {err:.3e} (tol {ATTN_ATOL[dtype]}), rel "
          f"norm {rel:.3e} (tol {ATTN_REL[dtype]})")
    torch.testing.assert_close(got, exp, atol=ATTN_ATOL[dtype],
                               rtol=ATTN_ATOL[dtype])
    if rel > ATTN_REL[dtype]:
        raise AssertionError(f"{label}: relative norm error {rel:.3e} above "
                             f"{ATTN_REL[dtype]}")
    return err, rel


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
    from repro_torch.kernels import csr as csr_index
    from repro_torch.kernels import dense_engine, fused_gnn, ref, seg_gather
    from repro_torch.kernels import shard_spmm
    from repro_torch.runtime.forward import gat_attention

    dev = engine.device
    gts = {a: engine.executable(f"{a}@pubmed", "pubmed").gt for a in ARCHS}
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    h = gts["gcn"].group(torch.from_numpy(ds.features).to(dev))  # (39, 512, 500)
    s, n, d = h.shape
    rows = s * n
    results = {}

    def record(*args, **kw):
        _record(results, *args, **kw)

    # shard_spmm: sage_mean's mean-normalized blocks over the graph's kept
    # linear index, as the serve path calls it: layer 0 (D 500), layer 1
    # (D 16) and a rectangular grid (the first third of the destination
    # shards against all source shards), and standalone at layer 0 (index
    # built in the call). Each is held to the plain version, and timed
    # beside its bound (index + h + out: only the nonzeros are needed), a
    # cuSPARSE CSR product over the same index and the dense einsum.
    mgt = gts["sage_mean"]
    blocks, mindex = mgt.blocks, mgt.linear_index                # (39, 39, 512, 512)
    if mindex.col.numel() != int((blocks != 0).sum().item()):
        raise AssertionError(f"linear index holds {mindex.col.numel()} "
                             f"entries, the blocks "
                             f"{(blocks != 0).sum().item()}")
    rect = blocks[: s // 3]
    spmm_cases = {"layer0": (blocks, h, mindex),
                  "layer1": (blocks, randn(s, n, 16), mindex),
                  "rectangular": (rect, h, csr_index.linear_index(rect))}
    spmm, outs = {}, {}
    for label, (blk, hh, idx) in spmm_cases.items():
        rows_dst, rows_src = blk.shape[0] * n, blk.shape[1] * n
        out = shard_spmm.shard_spmm(blk, hh, index=idx)
        plain = ref.shard_spmm(blk, hh)
        torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
        sparse = torch.sparse_csr_tensor(idx.row_ptr, idx.col, idx.val,
                                         size=(rows_dst, rows_src))

        def library(sparse=sparse, hh=hh, rows_src=rows_src, shape=out.shape):
            # the same function over the same kept index: cuSPARSE CSR x h
            return (sparse @ hh.reshape(rows_src, -1)).reshape(shape)

        torch.testing.assert_close(library(), plain, atol=1e-4, rtol=1e-4)
        nnz = idx.col.numel()
        index_bytes = _nbytes(idx.row_ptr, idx.col, idx.val)
        spmm[label] = {
            **_measure(out, plain,
                       lambda: shard_spmm.shard_spmm(blk, hh, index=idx),
                       lambda: ref.shard_spmm(blk, hh), library,
                       index_bytes + _nbytes(hh, out),
                       2.0 * nnz * hh.shape[-1]),
            "library_einsum_ms": _ms(lambda: torch.einsum(
                "ijvu,jud->ivd", blk, hh)),
            "host_ms": _host_ms(
                lambda: shard_spmm.shard_spmm(blk, hh, index=idx)),
            "dense_bytes_bound_ms": _nbytes(blk, hh, out)
            / PEAK_BYTES_PER_S * 1e3,
            "nnz": nnz, "index_bytes": index_bytes,
            "gathered_row_bytes": 4.0 * nnz * hh.shape[-1],
            "shape": {"s_dst": blk.shape[0], "s_src": blk.shape[1], "n": n,
                      "d": hh.shape[-1]}}
        outs[label] = (out, plain)
        print(f"shard_spmm {label}: {spmm[label]}")
        del sparse, library
    # gat's heads: the kernel over gat's kept index with one head's
    # attention weights as its values (shard_spmm_indexed, no blocks), at
    # layer 0's D 8 (16 hidden / 2 heads) and layer 1's D 3; the weights
    # are a softmax of random scores, as the forward makes them
    agt = gts["gat"]
    aindex = agt.linear_index
    alpha = gat_attention(aindex, csr_index.entry_rows(aindex),
                          randn(rows, 1), randn(rows, 1), 0.2)
    aindex = dataclasses.replace(aindex, val=alpha[:, 0].contiguous())
    for dd in (8, 3):
        hh = randn(s, n, dd)
        out = shard_spmm.shard_spmm_indexed(aindex, hh)
        plain = ref.spmm_indexed(aindex, hh)
        torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
        sparse = torch.sparse_csr_tensor(aindex.row_ptr, aindex.col,
                                         aindex.val, size=(rows, rows))
        nnz = aindex.col.numel()
        index_bytes = _nbytes(aindex.row_ptr, aindex.col, aindex.val)
        spmm[f"gat_head_d{dd}"] = {
            **_measure(out, plain,
                       lambda: shard_spmm.shard_spmm_indexed(aindex, hh),
                       lambda: ref.spmm_indexed(aindex, hh),
                       lambda: (sparse @ hh.reshape(rows, -1)).reshape(
                           s, n, -1),
                       index_bytes + _nbytes(hh, out), 2.0 * nnz * dd),
            "host_ms": _host_ms(
                lambda: shard_spmm.shard_spmm_indexed(aindex, hh)),
            "nnz": nnz, "shape": {"rows": rows, "d": dd}}
        print(f"shard_spmm gat_head_d{dd}: {spmm[f'gat_head_d{dd}']}")
        del sparse

    plain = outs["layer0"][1]
    out = shard_spmm.shard_spmm(blocks, h)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    index_runs, standalone_runs = [], []
    for _ in range(5):
        index_runs.append(_ms(lambda: csr_index.linear_index(blocks)))
        standalone_runs.append(_ms(lambda: shard_spmm.shard_spmm(blocks, h)))
    print(f"shard_spmm: linear index build {np.median(index_runs):.3f} ms "
          f"(rounds {', '.join(f'{t:.3f}' for t in index_runs)}); "
          f"standalone call (index built in the call) "
          f"{np.median(standalone_runs):.3f} ms (rounds "
          f"{', '.join(f'{t:.3f}' for t in standalone_runs)})")
    record("shard_spmm", spmm.pop("layer0"),
           bound_peak="3.35 TB/s; f32 67 TFLOP/s (CUDA cores)",
           library="cuSPARSE CSR x h over the kept index",
           standalone_ms=float(np.median(standalone_runs)),
           standalone_max_abs_err=(out - plain).abs().max().item(),
           index_build_ms=float(np.median(index_runs)),
           standalone_ms_rounds=standalone_runs,
           index_build_ms_rounds=index_runs, **spmm)
    del spmm_cases, outs, rect, out, plain

    # fused_gnn: gcn's normalized blocks over the graph's kept linear
    # index, as the serve path calls it, and standalone (index built in
    # the call); layer 0 (D 500 -> F 16, relu) and layer 1 (D 16 -> F 3)
    gt = gts["gcn"]
    gblocks, lindex = gt.blocks, gt.linear_index
    gnnz = lindex.col.numel()
    if gnnz != int((gblocks != 0).sum().item()):
        raise AssertionError(f"linear index holds {gnnz} entries, the "
                             f"blocks {(gblocks != 0).sum().item()}")
    w = randn(d, 16, scale=(2.0 / (d + 16)) ** 0.5)
    h1 = randn(s, n, 16)
    w1 = randn(16, 3, scale=(2.0 / 19) ** 0.5)
    layers = {0: (h, w, "relu"), 1: (h1, w1, "none")}
    outs, plains, errs = {}, {}, {}
    for layer, (hh, ww, act) in layers.items():
        plains[layer] = ref.fused_gnn(gblocks, hh, ww, activation=act)
        for idx in (lindex, None):
            outs[layer] = fused_gnn.fused_gnn_layer(gblocks, hh, ww,
                                                    activation=act, index=idx)
            torch.testing.assert_close(outs[layer], plains[layer], atol=1e-4,
                                       rtol=1e-4)
        errs[layer] = (outs[layer] - plains[layer]).abs().max().item()
    csr = torch.sparse_csr_tensor(lindex.row_ptr, lindex.col, lindex.val,
                                  size=(rows, rows))

    def library_kept(layer):
        # the same function over the same kept index: a cuSPARSE CSR
        # product, then the dense product, then the activation
        hh, ww, act = layers[layer]
        y = (csr @ hh.reshape(rows, -1)) @ ww
        return (torch.relu(y) if act == "relu" else y).reshape(s, n, -1)

    for layer in layers:
        torch.testing.assert_close(library_kept(layer), plains[layer],
                                   atol=1e-4, rtol=1e-4)
    index_runs, standalone_runs = [], []
    for _ in range(5):
        index_runs.append(_ms(lambda: csr_index.linear_index(gblocks)))
        standalone_runs.append(_ms(lambda: fused_gnn.fused_gnn_layer(
            gblocks, h, w, activation="relu")))
    index_ms = float(np.median(index_runs))
    standalone_ms = float(np.median(standalone_runs))
    print(f"fused_gnn: linear index build {index_ms:.3f} ms ({gnnz} "
          f"nonzeros, {rows} rows; rounds "
          f"{', '.join(f'{t:.3f}' for t in index_runs)}); standalone call "
          f"(index built in the call) {standalone_ms:.3f} ms (rounds "
          f"{', '.join(f'{t:.3f}' for t in standalone_runs)})")
    index_bytes = _nbytes(lindex.row_ptr, lindex.col, lindex.val)
    l1_bound, l1_by = _bound(index_bytes + _nbytes(h1, w1, outs[1]),
                             2.0 * gnnz * 16 + 2.0 * rows * 16 * 3)
    layer1 = {"shape": {"d": 16, "f": 3, "activation": "none"},
              "ms": _ms(lambda: fused_gnn.fused_gnn_layer(
                  gblocks, h1, w1, index=lindex)),
              "plain_ms": _ms(lambda: ref.fused_gnn(gblocks, h1, w1)),
              "library_ms": _ms(lambda: library_kept(1)),
              "bound_ms": l1_bound, "bound_by": l1_by,
              "max_abs_err": errs[1]}
    print(f"fused_gnn layer 1 (D 16 -> F 3): {layer1}")
    record("fused_gnn", _measure(
               outs[0], plains[0],
               lambda: fused_gnn.fused_gnn_layer(gblocks, h, w,
                                                 activation="relu",
                                                 index=lindex),
               lambda: ref.fused_gnn(gblocks, h, w, activation="relu"),
               lambda: library_kept(0),
               index_bytes + _nbytes(h, w, outs[0]),
               2.0 * gnnz * d + 2.0 * rows * d * 16),
           bound_peak="3.35 TB/s; f32 67 TFLOP/s (CUDA cores)",
           library="cuSPARSE CSR x h over the kept index, @ w, relu",
           library_einsum_ms=_ms(lambda: torch.relu(torch.einsum(
               "ivd,df->ivf", torch.einsum("ijvu,jud->ivd", gblocks, h), w))),
           nnz=gnnz, index_bytes=index_bytes,
           gathered_row_bytes=4.0 * gnnz * d,
           standalone_ms=standalone_ms, index_build_ms=index_ms,
           standalone_ms_rounds=standalone_runs,
           index_build_ms_rounds=index_runs, layer1=layer1)
    del csr

    # dense_engine: sage_max's pool transform (relu) and sage_mean's
    # concat product; 3xTF32 on the tensor cores, so also held to the
    # float64 product in relative norm (DENSE_REL)
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
    rel64 = {}
    for label, got, exact in (
            ("pool", dense_engine.dense_engine_matmul(x, wp, bp),
             torch.addmm(bp.double(), x.double(), wp.double())),
            ("concat", out2, x2.double() @ w2.double())):
        rel64[label] = ((got.double() - exact).norm() / exact.norm()).item()
        print(f"dense_engine {label}: relative norm vs float64 "
              f"{rel64[label]:.3e} (tol {DENSE_REL})")
        if rel64[label] > DENSE_REL:
            raise AssertionError(f"dense_engine {label}: relative norm "
                                 f"{rel64[label]:.3e} vs float64 above "
                                 f"{DENSE_REL}")
    tf32_peak = "3 TF32 passes at 495 TFLOP/s dense tensor cores, 3.35 TB/s"
    second_bound, second_by = _bound(_nbytes(x2, w2, out2),
                                     3 * 2.0 * rows * 2 * d * 16,
                                     PEAK_TF32_FLOPS)
    record("dense_engine", _measure(
               out, plain,
               lambda: dense_engine.dense_engine_matmul(x, wp, bp,
                                                        activation="relu"),
               lambda: ref.dense_engine(x, wp, bp, activation="relu"),
               lambda: torch.relu(torch.addmm(bp, x, wp)),
               _nbytes(x, wp, bp, out), 3 * 2.0 * rows * d * d,
               PEAK_TF32_FLOPS),
           bound_peak=tf32_peak,
           f32_cuda_core_bound_ms=2.0 * rows * d * d / PEAK_F32_FLOPS * 1e3,
           rel_err_f64=rel64["pool"], rel_tol=DENSE_REL,
           concat_product={"shape": [rows, 2 * d, 16],
                           "ms": _ms(lambda: dense_engine.dense_engine_matmul(
                               x2, w2)),
                           "plain_ms": _ms(lambda: ref.dense_engine(x2, w2)),
                           "library_ms": _ms(lambda: torch.mm(x2, w2)),
                           "library": "torch.mm (addmm without a bias)",
                           "bound_ms": second_bound, "bound_by": second_by,
                           "bound_peak": tf32_peak,
                           "rel_err_f64": rel64["concat"],
                           "max_abs_err": (out2 - plain2).abs().max().item()})

    # seg_gather: sage_max's edge lists, as the serve path calls it (with
    # the graph's gather index) and standalone (index built in the call);
    # max must be exact, sum within 1e-5
    gt = gts["sage_max"]
    index = gt.gather_index
    z = torch.relu(x @ wp + bp).reshape(s, n, d)
    edges = (gt.edge_src, gt.edge_dst, gt.edge_valid)
    plain = ref.seg_gather(*edges, z, op="max")
    # sum's plain version on the CPU, which adds in slot order as the
    # kernel does; on the card its index_add_ adds in any order
    plain_sum = ref.seg_gather(*(t.cpu() for t in edges), z.cpu(),
                               op="sum").to(dev)
    out = out_sum = None
    for idx in (index, None):
        out = seg_gather.seg_gather_aggregate(*edges, z, op="max", index=idx)
        if not torch.equal(out, plain):
            raise AssertionError(
                f"seg_gather max (index {'built' if idx is None else 'kept'}) "
                f"differs from its plain version: max abs err "
                f"{(out - plain).abs().max().item():.3e}")
        out_sum = seg_gather.seg_gather_aggregate(*edges, z, op="sum",
                                                  index=idx)
        torch.testing.assert_close(out_sum, plain_sum, atol=1e-5, rtol=1e-5)
    valid = int(gt.edge_valid.sum().item())
    if int(index.row_ptr[-1].item()) != valid:
        raise AssertionError(f"gather index holds {index.row_ptr[-1].item()}"
                             f" edges, the edge lists {valid}")
    # the index build and the standalone call read nonzero's count back to
    # the host, so their times follow the host's speed: five rounds each,
    # interleaved, the median kept
    index_runs, standalone_runs = [], []
    for _ in range(5):
        index_runs.append(_ms(lambda: seg_gather.gather_index(*edges, n)))
        standalone_runs.append(_ms(lambda: seg_gather.seg_gather_aggregate(
            *edges, z, op="max")))
    index_ms = float(np.median(index_runs))
    standalone_ms = float(np.median(standalone_runs))
    print(f"seg_gather: gather index build {index_ms:.3f} ms "
          f"({valid} edges, {rows} rows; rounds "
          f"{', '.join(f'{t:.3f}' for t in index_runs)}); standalone call "
          f"(index built in the call) {standalone_ms:.3f} ms (rounds "
          f"{', '.join(f'{t:.3f}' for t in standalone_runs)})")

    def library_index():
        # valid slots -> global destination (expanded over D) and source ids
        ii, jj, ee = gt.edge_valid.nonzero(as_tuple=True)
        dst = (ii * n + gt.edge_dst[ii, jj, ee].long())[:, None].expand(-1, d)
        return dst, jj * n + gt.edge_src[ii, jj, ee].long()

    def library_reduce(dst, src):
        # gather of the source rows, one scatter_reduce, empty -> 0
        acc = torch.full((rows, d), float("-inf"), device=dev).scatter_reduce_(
            0, dst, z.reshape(-1, d).index_select(0, src), reduce="amax",
            include_self=True)
        return torch.where(torch.isfinite(acc), acc, 0.0)

    def library():
        # the whole function from the same inputs, as the kernel's
        # standalone call
        return library_reduce(*library_index())

    # the library path with its index kept, as the kernel's serve path
    kept = library_index()
    if not torch.equal(library_reduce(*kept).reshape(s, n, d), plain):
        raise AssertionError("the library path differs from the plain "
                             "version")
    library_kept_index_ms = _ms(lambda: library_reduce(*kept))

    record("seg_gather", _measure(
               out, plain,
               lambda: seg_gather.seg_gather_aggregate(*edges, z, op="max",
                                                       index=index),
               lambda: ref.seg_gather(*edges, z, op="max"),
               library,
               _nbytes(gt.edge_src, gt.edge_dst, gt.edge_valid, z, out),
               float(valid * d)),
           valid_edges=valid, edge_slots=int(gt.edge_valid.numel()),
           sum_max_abs_err=(out_sum - plain_sum).abs().max().item(),
           standalone_ms=standalone_ms, index_build_ms=index_ms,
           standalone_ms_rounds=standalone_runs,
           index_build_ms_rounds=index_runs,
           library_kept_index_ms=library_kept_index_ms,
           index_bytes=_nbytes(index.row_ptr, index.src),
           source_row_bytes=4.0 * valid * d)
    return results


def serve_phase(engine, ds, args, kernels) -> dict:
    """Drive the engine through the Server; every kernel in ``kernels``
    must launch. Returns the launch counts."""
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
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the GNN path: "
                             f"{missing}")
    wrong = {k: launches[k] for k, c in GNN_LAUNCHES.items()
             if launches[k] != c}
    if wrong:
        raise AssertionError(f"GNN path launches {wrong}, expected "
                             f"{GNN_LAUNCHES}")

    for arch in ARCHS:
        exe = engine.executable(f"{arch}@pubmed", "pubmed")
        logits, fwd_launches = _launched(exe.forward)
        if fwd_launches != FORWARD_LAUNCHES[arch]:
            raise AssertionError(f"{arch}: a forward launched "
                                 f"{fwd_launches}, expected "
                                 f"{FORWARD_LAUNCHES[arch]}")
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
              f"backend max_abs_err {err:.3e} (|logit| max "
              f"{expect.abs().max().item():.3e}) | full-graph forward "
              f"{fwd_ms:.3f} ms (host clock, synchronized)")
    return launches


def _launched(fn):
    """``fn()`` and the kernel launches it made (nonzero counts only)."""
    from repro_torch.kernels import _lib

    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launches().items() if v}


def _step_split(tr, batch, reps: int = 10) -> dict:
    """Median host times (ms, each part ended by a sync) of a train
    step's forward (recorded by autograd, with the loss), its backward
    and the AdamW update, run part by part as ``step_fn`` runs them, and
    of ``step_fn`` whole."""
    from repro_torch import runtime
    from repro_torch.training.optimizer import (adamw_update, tree_leaves,
                                                tree_unflatten)

    fwd = tr.executable._forward_fn()
    h, labels, mask = batch
    parts = {"forward": [], "backward": [], "update": [], "step": []}
    for _ in range(reps):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(tr.params)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = runtime.masked_cross_entropy(
            fwd(tree_unflatten(tr.params, leaves), h), labels, mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(tree_unflatten(tr.params, grads), tr.opt_state,
                     tr.params, tr.opt_cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(dt * 1e3)
    return {key: float(np.median(v)) for key, v in parts.items()}


def train_phase(engine, ds, card: str) -> dict:
    """Full-batch training of each arch on Pubmed through the kernels:
    step-0 gradients held to the reference backend, one step's launches
    equal to its forward's, ``runtime.fit`` for ``TRAIN_STEPS`` steps with
    the loss falling, the trained executable equal to a fresh compile,
    and the step's time split. Returns the launches of the counted steps,
    summed over the archs."""
    from repro_torch import runtime
    from repro_torch.runtime.executable import _flatten_params

    dev, quiet = engine.device, (lambda line: None)
    store = runtime.GraphStore()      # one graph build per signature
    kw = dict(device=dev, max_shard_n=engine.max_shard_n, store=store)
    step_launches: dict = {}
    for arch in ARCHS:
        served = engine.executable(f"{arch}@pubmed", "pubmed")
        spec, params = served.spec, served.params
        t0 = time.perf_counter()
        trainers = {
            backend: runtime.TrainableExecutable(
                runtime.compile(spec, ds, backend=backend, params=params,
                                **kw),
                ds.labels, train_mask=ds.train_mask)
            for backend in ("cuda", "reference")}
        setup_s = time.perf_counter() - t0
        tr = trainers["cuda"]
        batch = tr.data(0)
        (loss, _, grads), launches = _launched(
            lambda: tr.loss_and_grads(tr.params, batch))
        tr_ref = trainers["reference"]
        loss_ref, _, grads_ref = tr_ref.loss_and_grads(tr_ref.params,
                                                       tr_ref.data(0))
        ours, theirs = _flatten_params(grads), _flatten_params(grads_ref)
        rels = {name: float(np.linalg.norm(ours[name] - g) / max(
                    np.linalg.norm(g), 1e-30)) for name, g in theirs.items()}
        worst = max(rels, key=rels.get)
        if rels[worst] > GRAD_REL or not all(
                np.isfinite(g).all() for g in ours.values()):
            raise AssertionError(f"{arch}: step-0 gradients vs reference "
                                 f"backend, relative norms {rels} (limit "
                                 f"{GRAD_REL})")
        _, launches = _launched(lambda: tr.step_fn(tr.params, tr.opt_state,
                                                   batch))
        if launches != FORWARD_LAUNCHES[arch]:
            raise AssertionError(f"{arch}: a train step launched {launches},"
                                 f" its forward {FORWARD_LAUNCHES[arch]}")
        for k, v in launches.items():
            step_launches[k] = step_launches.get(k, 0) + v

        ms = _step_split(tr, batch)

        t0 = time.perf_counter()
        res = runtime.fit(spec, ds, steps=TRAIN_STEPS, lr=TRAIN_LR,
                          params=params, log_every=1, log=quiet, **kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        losses = [loss for _, loss in res.history]
        if len(losses) != TRAIN_STEPS or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: losses {losses} did not fall")
        fresh = runtime.compile(spec, ds, params=res.params, **kw)
        trained, again = res.executable.forward(), fresh.forward()
        if not torch.equal(trained, again):
            raise AssertionError(
                f"{arch}: the trained executable's logits differ from a "
                f"fresh compile's by {(trained - again).abs().max().item()}")
        print(f"train {arch} ({card}, Pubmed full-batch): step-0 loss "
              f"{loss.item():.6f} (reference {loss_ref.item():.6f}), "
              f"gradient relative norms max {rels[worst]:.3e} at {worst} "
              f"(limit {GRAD_REL}); step launches {launches}; median ms (host "
              f"clock, synchronized): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; fit {TRAIN_STEPS} steps in {fit_s:.3f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, train accuracy "
              f"{res.train_accuracy():.3f}; setup {setup_s:.1f} s")
        _profile(lambda: tr.step_fn(tr.params, tr.opt_state, batch),
                 f"train {arch} step", card)
        del trainers, tr, tr_ref, res, fresh, grads, grads_ref
    del store
    gc.collect()
    torch.cuda.empty_cache()
    return step_launches


def minibatch_phase(ds, dev, card: str, max_shard_n: int) -> None:
    """gcn mini-batch training on Pubmed: ``MB_STEPS`` steps of
    ``MB_BATCH_NODES`` seeds, fanout ``MB_FANOUT``; each step's time and
    its host part."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.kernels import csr

    prof = ds.profile
    spec = ZooSpec("gcn", prof.feature_dim, 16, prof.num_classes)
    t0 = time.perf_counter()
    res = runtime.fit(spec, ds, steps=MB_STEPS, lr=TRAIN_LR,
                      batch_nodes=MB_BATCH_NODES, fanout=MB_FANOUT,
                      device=dev, max_shard_n=max_shard_n, log_every=1,
                      log=lambda line: None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tr = res.trainable
    losses = [loss for _, loss in res.history]
    if len(losses) != MB_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"mini-batch losses {losses}")
    rows = []
    for step in range(MB_STEPS, MB_STEPS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = tr.data(step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        csr.linear_index(batch[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, launches = _launched(lambda: tr.step_fn(tr.params, tr.opt_state,
                                                   batch))
        t3 = time.perf_counter()
        rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        if launches != FORWARD_LAUNCHES["gcn"]:
            raise AssertionError(f"a mini-batch step launched {launches}")
    data_ms, index_ms, step_ms = (float(np.median(c)) for c in zip(*rows))
    s_sub, n_sub, e_cap = tr._mb_shape
    print(f"train gcn mini-batch ({card}, Pubmed, {MB_BATCH_NODES} seeds, "
          f"fanout {MB_FANOUT}, budget {tr.sampler.budget} nodes, template "
          f"S {s_sub} n {n_sub} edge cap {e_cap}): fit {MB_STEPS} steps in "
          f"{fit_s:.3f} s, losses {[round(x, 4) for x in losses]}; median "
          f"ms (host clock, synchronized): sample + shard + upload "
          f"{data_ms:.3f}, index build {index_ms:.3f}, step (its own index "
          f"build included) {step_ms:.3f}")
    del res, tr
    gc.collect()
    torch.cuda.empty_cache()


def _synced(fn):
    """``fn()`` and its host time in ms, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _stream_fresh_check(engine, ds, label: str) -> dict:
    """Each arch's served logits against a fresh compile of the current
    graph on a fresh store: equal bitwise on the ``cuda`` backend, within
    1e-4 of the ``reference`` backend; a served forward launches exactly
    ``FORWARD_LAUNCHES``. Returns the fresh logits by arch."""
    from repro_torch import runtime

    store = runtime.GraphStore()
    fresh_logits = {}
    for arch in ARCHS:
        exe = engine.executable(arch, "pubmed")
        logits, launches = _launched(exe.forward)
        if launches != FORWARD_LAUNCHES[arch]:
            raise AssertionError(f"stream {label} {arch}: a forward launched "
                                 f"{launches}, expected "
                                 f"{FORWARD_LAUNCHES[arch]}")
        kw = dict(device=engine.device, params=exe.params,
                  max_shard_n=engine.max_shard_n, store=store)
        fresh = runtime.compile(exe.spec, ds, backend="cuda", **kw).forward()
        if fresh.shape != logits.shape or not torch.equal(logits, fresh):
            raise AssertionError(
                f"stream {label} {arch}: served logits {tuple(logits.shape)}"
                f" differ from a fresh compile's {tuple(fresh.shape)}"
                + (f" by {(logits - fresh).abs().max().item():.3e}"
                   if fresh.shape == logits.shape else ""))
        expect = runtime.compile(exe.spec, ds, backend="reference",
                                 **kw).forward()
        err = (logits - expect).abs().max().item()
        torch.testing.assert_close(logits, expect, atol=1e-4, rtol=1e-4)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"stream {label} {arch}: non-finite logits")
        print(f"stream {label} {arch}: served logits {tuple(logits.shape)} "
              f"equal a fresh cuda compile bitwise; vs reference backend "
              f"max_abs_err {err:.3e}; forward launches {launches}")
        fresh_logits[arch] = fresh
    del store
    return fresh_logits


def stream_phase(dev, card: str, max_shard_n: int) -> dict:
    """Serve a live full-scale Pubmed while deltas land and a gcn
    StreamTrainer fine-tunes it (see the module docstring, 4d). Returns
    the kernel launches of the stream run."""
    from repro_torch.gnn.models import ZooSpec, graph_signature
    from repro_torch.graphs import GraphDelta
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.graphs.delta import affected_nodes, seed_nodes
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import latency_percentiles
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
    from repro_torch.stream import StreamTrainer, random_delta

    t_phase = t0 = time.perf_counter()
    ds = make_dataset("pubmed", seed=0)       # the stream mutates its own
    prof = ds.profile
    n_start = prof.num_nodes
    engine = GNNServeEngine(device=dev, max_shard_n=max_shard_n,
                            streaming=True, edge_slack=0.25,
                            invalidation="targeted")
    engine.register_graph("pubmed", ds)
    for arch in ARCHS:
        engine.register_model(arch, ZooSpec(arch, prof.feature_dim, 16,
                                            prof.num_classes), seed=0)
    server = Server(engine, SchedulerConfig(max_batch_size=STREAM_BATCH))
    trainer = StreamTrainer(server, graph="pubmed", model="gcn",
                            log=lambda line: None, **STREAM_TRAINER)
    rng = np.random.default_rng(0)

    def requests(ids_of) -> list:
        tickets = [server.submit(NodeRequest("pubmed", ids_of(arch),
                                             model=arch)) for arch in ARCHS]
        server.drain()
        outs = [t.result() for t in tickets]
        if not all(isinstance(o, Completed) for o in outs):
            raise AssertionError(f"stream: requests not completed: {outs}")
        return outs

    def random_ids(arch):
        return rng.integers(0, ds.profile.num_nodes, size=STREAM_NODES)

    requests(random_ids)        # compile every arch, cache its softmax
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"stream setup ({card}): Pubmed {n_start} nodes, "
          f"{len(ARCHS)} archs compiled on mutable builds (slack 0.25) in "
          f"{setup_s:.1f} s; {engine.cache_report()}")

    # the burst: requests, a delta, a fine-tune round every few deltas
    torch.cuda.synchronize()
    _lib.reset_launches()
    outcomes, reps, walls, rounds = [], [], [], []
    t0 = time.perf_counter()
    for m in range(STREAM_DELTAS):
        outcomes += requests(random_ids)
        delta = random_delta(ds, rng, edge_ops=STREAM_EDGE_OPS,
                             p_node=STREAM_P_NODE)
        rep, wall = _synced(lambda: server.mutate("pubmed", delta))
        reps.append(rep)
        walls.append(wall)
        if (m + 1) % STREAM_FINETUNE_EVERY == 0:
            rounds.append(trainer.round())
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    s = engine.stats
    if s["graph_recompiles"] or s["graph_patch_rebuilds"] \
            or trainer.stats["rebuilds"]:
        raise AssertionError(
            f"stream: in-template burst recompiled {s['graph_recompiles']}"
            f", patch rebuilds {s['graph_patch_rebuilds']}, trainer "
            f"rebuilds {trainer.stats['rebuilds']}")
    if trainer.stats["rounds"] != STREAM_DELTAS // STREAM_FINETUNE_EVERY \
            or trainer.stats["reloads"] != trainer.stats["rounds"]:
        raise AssertionError(f"stream trainer stats {trainer.stats}")
    losses = [r["loss"] for r in rounds]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"stream trainer losses {losses}")

    t_measured = time.perf_counter()
    # one more delta, measured: the index rebuild per signature, then a
    # request for its affected nodes per arch (the cold request)
    edges_before, num_before = ds.edges.copy(), ds.profile.num_nodes
    delta = random_delta(ds, rng, edge_ops=STREAM_EDGE_OPS,
                         p_node=STREAM_P_NODE)
    rep, wall = _synced(lambda: server.mutate("pubmed", delta))
    reps.append(rep)
    walls.append(wall)
    affected = {}
    for arch in ARCHS:
        norm, _ = graph_signature(arch)
        seeds = seed_nodes(delta, edges_before, ds.edges, num_before, norm)
        affected[arch] = affected_nodes(ds.edges, seeds, 1,
                                        ds.profile.num_nodes)
    index_ms = {}
    for arch in ARCHS:
        gt = engine.executable(arch, "pubmed").gt
        sig = "/".join(map(str, graph_signature(arch)))
        kind = "gather" if arch == "sage_max" else "linear"
        if (sig, kind) not in index_ms:
            index_ms[(sig, kind)] = _synced(
                lambda: getattr(gt, f"{kind}_index"))[1]
    cold = requests(lambda arch: affected[arch])
    torch.cuda.synchronize()
    launches = {k: v for k, v in _lib.launches().items() if v}
    missing = [k for k in ("shard_spmm", "fused_gnn", "dense_engine",
                           "seg_gather") if not launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the stream path: "
                             f"{missing} (launches {launches})")
    warm = {}
    for arch in ARCHS:
        exe = engine.executable(arch, "pubmed")
        warm[arch] = float(np.median(
            [_synced(exe.forward)[1] for _ in range(3)]))

    # the device update alone: each signature's copy-on-write update for
    # the measured delta's affected pairs, replayed on its current build
    # (CUDA events), and its parts: the four clones (CUDA events), the
    # host gather of the pairs from the mirror and their upload (host
    # clock, synchronized; medians of 5)
    device_ms = {}
    for (norm, loops), res in rep["patches"].items():
        arch = next(a for a in ARCHS if graph_signature(a) == (norm, loops))
        exe = engine.executable(arch, "pubmed")
        entry = engine.store.get(
            "pubmed", ds.edges, ds.profile.num_nodes, exe.plan.shard_n, arch,
            device=dev, version=engine.graph_version("pubmed"), mutable=True)
        ps, gt, (ai, aj) = entry.patch_state, entry.gt, res.pairs
        mirrors = (ps.blocks, ps.edge_src, ps.edge_dst, ps.edge_valid)
        gathers, uploads = [], []
        for _ in range(5):
            subs, ms = _synced(lambda: [np.ascontiguousarray(a[ai, aj])
                                        for a in mirrors])
            gathers.append(ms)
            uploads.append(_synced(lambda: [torch.from_numpy(x).to(dev)
                                            for x in subs])[1])
        device_ms[f"{norm}/{loops}"] = {
            "pairs": res.shards_patched,
            "update_ms": _ms(lambda: ps.to_graph_tensors(prev=gt,
                                                         pairs=res.pairs)),
            "clone_ms": _ms(lambda: [t.clone() for t in (
                gt.blocks, gt.edge_src, gt.edge_dst, gt.edge_valid)]),
            "host_gather_ms": float(np.median(gathers)),
            "upload_ms": float(np.median(uploads)),
            "upload_mb": sum(x.nbytes for x in subs) / 1e6}
        del subs

    fresh = _stream_fresh_check(engine, ds, "after the burst")
    for o, arch in zip(cold, ARCHS):
        want = fresh[arch][affected[arch]].argmax(-1).cpu().numpy()
        if not np.array_equal(o.value.classes, want):
            raise AssertionError(f"stream {arch}: the affected nodes' served "
                                 f"classes differ from a fresh compile's")
    del fresh

    lat = latency_percentiles(outcomes)
    host = [r["patch_host_ms"] for r in reps]
    dev_part = [r["patch_ms"] - r["patch_host_ms"] for r in reps]
    rest = [r["mutate_ms"] - r["patch_ms"] for r in reps]
    inv = [sum(x.get("rows_invalidated", 0) for x in r["executables"])
           for r in reps]
    cached = [sum(x.get("rows_cached", 0) for x in r["executables"])
              for r in reps]
    pairs = [sum(p.shards_patched for p in r["patches"].values())
             for r in reps]

    def med_max(xs):
        return f"median {np.median(xs):.3f} max {np.max(xs):.3f}"

    print(f"stream burst ({card}): {STREAM_DELTAS} deltas "
          f"(+1 measured), {len(outcomes)}/{len(outcomes)} requests "
          f"completed in {burst_s:.3f} s; graph {n_start} -> "
          f"{ds.profile.num_nodes} nodes; stats {engine.stats}")
    print(f"stream mutate ms (host clock): synchronized wall "
          f"{med_max(walls)}; host patch of the 4 signatures' mirrors "
          f"{med_max(host)}; rest of the store patch (device clone + "
          f"upload as enqueued, feature regroup) {med_max(dev_part)}; "
          f"invalidation math + update_graph {med_max(rest)}; shard pairs "
          f"patched per delta (4 signatures) {med_max(pairs)}")
    print("stream device update of the measured delta, per signature "
          "(update: clone + gather + upload + write, CUDA events): "
          + "; ".join(f"{sig} {d['pairs']} pairs: update "
                      f"{d['update_ms']:.3f} ms, clone {d['clone_ms']:.3f}"
                      f" ms, host gather {d['host_gather_ms']:.3f} ms, "
                      f"upload {d['upload_mb']:.1f} MB "
                      f"{d['upload_ms']:.3f} ms"
                      for sig, d in device_ms.items()))
    print("stream index rebuild at the first forward after a delta (host "
          "clock, synchronized): " + ", ".join(
              f"{sig} {kind} {ms:.3f} ms"
              for (sig, kind), ms in index_ms.items()))
    print("stream post-delta per arch: " + "; ".join(
        f"{arch} cold request (forward + softmax, {len(affected[arch])} "
        f"affected nodes) {o.value.engine_ms:.3f} ms, warm forward "
        f"{warm[arch]:.3f} ms" for arch, o in zip(ARCHS, cold)))
    print(f"stream rows invalidated per delta (5 executables): "
          f"{med_max(inv)} of {med_max(cached)} cached; request latency "
          f"p50 {lat[0]:.3f} ms, p95 {lat[1]:.3f} ms, p99 {lat[2]:.3f} ms")
    print("stream trainer (gcn, batch 32, fanout (5, 5), 20 steps a "
          "round): " + "; ".join(
              f"round {r['round']} loss {r['loss']:.4f} acc "
              f"{r['train_acc']:.3f} {r['round_ms']:.1f} ms (dirty "
              f"{r['dirty_nodes']}, pool {r['seed_pool']})" for r in rounds))
    print(f"stream launches {launches}")

    # the compaction: more new nodes than the template has left
    t_compact = time.perf_counter()
    gt = engine.executable("gcn", "pubmed").gt
    n0 = ds.profile.num_nodes
    k = gt.S * gt.n - n0 + 1
    like = rng.integers(0, n0, size=k)
    grow = GraphDelta(add_nodes=k, add_features=ds.features[like],
                      add_labels=ds.labels[like],
                      add_edges=np.stack([n0 + np.arange(k), like], 1))
    del gt
    compiles0 = engine.stats["compile_ms_total"]
    rep, wall = _synced(lambda: server.mutate("pubmed", grow))
    reasons = {p.reason for p in rep["patches"].values()}
    if not rep["rebuilt"] or reasons != {"node-capacity"} or \
            engine.stats["graph_recompiles"] != len(ARCHS) or \
            not all(x["recompile"] for x in rep["executables"]):
        raise AssertionError(f"stream compaction: {rep['executables']}, "
                             f"reasons {reasons}, stats {engine.stats}")
    grown = requests(lambda arch: np.array([0, n0, n0 + k - 1]))
    torch.cuda.synchronize()
    print(f"stream compaction ({card}): +{k} nodes -> "
          f"{ds.profile.num_nodes} (S {engine.executable('gcn', 'pubmed').gt.S}"
          f"), mutate {wall:.3f} ms synchronized (host patch "
          f"{rep['patch_host_ms']:.3f} ms, store patch {rep['patch_ms']:.3f} "
          f"ms); lazy recompiles {engine.stats['compile_ms_total'] - compiles0:.3f}"
          f" ms; first requests engine_ms "
          + ", ".join(f"{a} {o.value.engine_ms:.3f}"
                      for a, o in zip(ARCHS, grown)))
    _stream_fresh_check(engine, ds, "after the compaction")
    del engine, server, trainer, ds
    gc.collect()
    torch.cuda.empty_cache()
    t_end = time.perf_counter()
    print(f"stream phase wall time ({card}): {t_end - t_phase:.1f} s "
          f"(setup {setup_s:.1f} s, burst {burst_s:.1f} s, measured delta "
          f"+ timings + fresh check {t_compact - t_measured:.1f} s, "
          f"compaction + fresh check + free {t_end - t_compact:.1f} s)")
    return launches


def _plan_launches(arch: str, plan) -> dict:
    """One forward's kernel launches under ``plan``: each gcn layer runs
    the fused kernel, or shard_spmm then dense_engine, as its fused flag
    says; the other archs never fuse and launch ``FORWARD_LAUNCHES``."""
    if arch != "gcn":
        return FORWARD_LAUNCHES[arch]
    out: dict = {}
    for p in plan.layers:
        for k in ("fused_gnn",) if p.fused else ("shard_spmm",
                                                 "dense_engine"):
            out[k] = out.get(k, 0) + 1
    return out


def tune_phase(dev, card: str) -> dict:
    """Serve the five archs on full-scale Pubmed with autotuned plans,
    hold each to the reference and analytic compiles, check the winner
    memo in process and on disk, and train gcn with its tuned plan (see
    the module docstring, 4e). Returns the kernel launches of the tuned
    serve run (tuning included)."""
    from repro_torch import env

    print(f"tune env ({card}): {json.dumps(env.pin_for_benchmarks())}")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    saved_cache = os.environ.get("REPRO_PLAN_CACHE")
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["REPRO_PLAN_CACHE"] = cache_dir
        try:
            launches = _tune_run(dev, card, cache_dir)
        finally:
            if saved_cache is None:
                os.environ.pop("REPRO_PLAN_CACHE", None)
            else:
                os.environ["REPRO_PLAN_CACHE"] = saved_cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tune phase wall time ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches


def _tune_run(dev, card: str, cache_dir: str) -> dict:
    """The tune phase inside its plan cache directory."""
    from repro_torch import runtime
    from repro_torch.analyze import plan_lint
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import latency_percentiles
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    runtime.clear_tune_cache()
    ds = make_dataset("pubmed", seed=0)
    prof = ds.profile
    engine = GNNServeEngine(device=dev, plan="autotune",
                            tune_budget=TUNE_BUDGET,
                            max_shard_n=TUNE_MAX_SHARD_N)
    engine.register_graph("pubmed", ds)
    for arch in ARCHS:
        engine.register_model(arch, ZooSpec(arch, prof.feature_dim, 16,
                                            prof.num_classes), seed=0)
    server = Server(engine, SchedulerConfig(max_batch_size=4))
    rng = np.random.default_rng(0)

    # the main path: requests whose first compile per model tunes it
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    tickets = [server.submit(NodeRequest(
        "pubmed", rng.integers(0, prof.num_nodes, size=8), model=arch))
        for _ in range(TUNE_REQUESTS) for arch in ARCHS]
    server.drain()
    outcomes = [t.result() for t in tickets]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _lib.launches()
    if not all(isinstance(o, Completed) for o in outcomes):
        raise AssertionError(f"tune: requests not completed: {outcomes}")
    missing = [k for k in ("shard_spmm", "fused_gnn", "dense_engine",
                           "seg_gather") if launches[k] == 0]
    if missing:
        raise AssertionError(f"tune: kernels never launched: {missing}")
    store = engine.store
    builds = store.stats["misses"]
    p50, _, p99 = latency_percentiles(outcomes)
    print(f"tune serve ({card}, Pubmed {prof.num_nodes} nodes, budget "
          f"{TUNE_BUDGET}, max_shard_n {TUNE_MAX_SHARD_N}): "
          f"{len(outcomes)} requests in {serve_s:.3f} s (compiles with "
          f"tuning {engine.stats['compile_ms_total']:.1f} ms), latency p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms; {builds} graph builds, host "
          f"build {store.stats['built_ms_total'] / builds:.1f} ms per "
          f"signature; launches {launches}")

    measured0 = runtime.tune_cache_stats()["measurements"]
    for arch in ARCHS:
        exe = engine.executable(arch, "pubmed")
        rep = exe.tune_report
        if exe.plan_source != "autotune" or rep["candidates_failed"]:
            raise AssertionError(f"tune {arch}: {exe.plan_source}, {rep}")
        logits, fwd = _launched(exe.forward)
        if fwd != _plan_launches(arch, exe.plan):
            raise AssertionError(f"tune {arch}: a forward launched {fwd}, "
                                 f"the winner's plan says "
                                 f"{_plan_launches(arch, exe.plan)}")
        kw = dict(device=dev, params=exe.params,
                  max_shard_n=TUNE_MAX_SHARD_N, store=store,
                  graph_key="pubmed")
        expect = runtime.compile(exe.spec, ds, backend="reference",
                                 **kw).forward()
        err = (logits - expect).abs().max().item()
        torch.testing.assert_close(logits, expect, atol=1e-4, rtol=1e-4)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"tune {arch}: non-finite logits")
        analytic = runtime.compile(exe.spec, ds, **kw)
        same = plan_lint.executed_digest(exe.plan) == \
            plan_lint.executed_digest(analytic.plan)
        if same and not torch.equal(logits, analytic.forward()):
            raise AssertionError(f"tune {arch}: the winner runs the analytic "
                                 f"program but its logits differ")
        again = runtime.compile(exe.spec, ds, plan="autotune",
                                tune_budget=TUNE_BUDGET,
                                plan_cache_dir=cache_dir, **kw)
        if again.plan != exe.plan or \
                runtime.tune_cache_stats()["measurements"] != measured0:
            raise AssertionError(f"tune {arch}: a second compile measured "
                                 f"again: {runtime.tune_cache_stats()}")
        fused = [p.fused for p in exe.plan.layers]
        print(f"tune {arch} ({card}): {rep['candidates_measured']} measured, "
              f"{rep['candidates_pruned']} pruned {rep['pruned_reasons']}; "
              f"winner {rep['winner_ms']:.4f} ms (fused {fused}, shard_n "
              f"{exe.plan.shard_n}) vs analytic {rep['analytic_ms']:.4f} ms, "
              f"speedup {rep['speedup']:.4f}; vs reference max_abs_err "
              f"{err:.3e}; {'bitwise equal to' if same else 'another program than'}"
              f" the analytic compile; forward launches {fwd}")

    runtime.clear_tune_cache()       # a new process: winners from disk
    for arch in ARCHS:
        exe = engine.executable(arch, "pubmed")
        back = runtime.compile(exe.spec, ds, device=dev, params=exe.params,
                               max_shard_n=TUNE_MAX_SHARD_N, store=store,
                               graph_key="pubmed", plan="autotune",
                               tune_budget=TUNE_BUDGET)
        if back.plan != exe.plan:
            raise AssertionError(f"tune {arch}: the disk winner differs")
    stats = runtime.tune_cache_stats()
    if stats["disk_hits"] != len(ARCHS) or stats["measurements"]:
        raise AssertionError(f"tune: disk reload {stats}")
    print(f"tune memo: second compiles measured nothing; after "
          f"clear_tune_cache() {stats}")

    gcn = engine.executable("gcn", "pubmed")
    t0 = time.perf_counter()
    res = runtime.fit(gcn.spec, ds, steps=TUNE_FIT_STEPS, lr=TRAIN_LR,
                      device=dev, max_shard_n=TUNE_MAX_SHARD_N,
                      params=gcn.params, store=store, plan="autotune",
                      tune_budget=TUNE_BUDGET, log_every=1,
                      log=lambda line: None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tr = res.trainable
    losses = [loss for _, loss in res.history]
    if res.executable.plan_source != "autotune" or \
            res.executable.plan != gcn.plan or \
            len(losses) != TUNE_FIT_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"tune fit: {res.executable.plan_source}, "
                             f"losses {losses}")
    batch = tr.data(0)
    _, step = _launched(lambda: tr.step_fn(tr.params, tr.opt_state, batch))
    if step != _plan_launches("gcn", gcn.plan):
        raise AssertionError(f"tune fit: a step launched {step}")
    print(f"tune fit gcn ({card}): {TUNE_FIT_STEPS} steps on the tuned "
          f"plan in {fit_s:.3f} s (measured "
          f"{runtime.tune_cache_stats()['measurements']} candidates), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step launches {step}")
    del engine, server, res, tr, store, gcn
    return launches


def _mesh_kernel_rows(exe, kernels: dict) -> None:
    """The two kernels of the sharded path at its local shapes, each held
    to its plain version and timed beside it, its bound and a library
    call: shard_spmm over data group 0's rectangular local grid (10, 40,
    512, 512) with its kept index at D 250 (layer 0's feature block), and
    dense_engine's row-parallel product (5120, 250) @ (250, 16)."""
    from repro_torch.kernels import dense_engine, ref, shard_spmm

    dev = exe.device
    gen = torch.Generator().manual_seed(1)
    blk, idx = exe.group_blocks()[0], exe.group_indexes()[0]
    s_dst, s_src, n, _ = blk.shape
    bm = -(-exe.spec.in_dim // exe.n_model)
    h = torch.randn((s_src, n, bm), generator=gen).to(dev)
    out = shard_spmm.shard_spmm(blk, h, index=idx)
    plain = ref.shard_spmm(blk, h)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    rows_dst, rows_src = s_dst * n, s_src * n
    sparse = torch.sparse_csr_tensor(idx.row_ptr, idx.col, idx.val,
                                     size=(rows_dst, rows_src))

    def library():
        # the same function over the same kept index: cuSPARSE CSR x h
        return (sparse @ h.reshape(rows_src, -1)).reshape(out.shape)

    torch.testing.assert_close(library(), plain, atol=1e-4, rtol=1e-4)
    nnz = idx.col.numel()
    row = _measure(out, plain,
                   lambda: shard_spmm.shard_spmm(blk, h, index=idx),
                   lambda: ref.shard_spmm(blk, h), library,
                   _nbytes(idx.row_ptr, idx.col, idx.val, h, out),
                   2.0 * nnz * bm)
    row.update(shape={"s_dst": s_dst, "s_src": s_src, "n": n, "d": bm},
               nnz=nnz, library="cuSPARSE CSR x h over the kept index",
               bound_peak="3.35 TB/s; f32 67 TFLOP/s (CUDA cores)")
    kernels["shard_spmm"]["mesh_local"] = row
    print(f"kernel shard_spmm, mesh local grid: {row}")

    x = torch.randn((rows_dst, bm), generator=gen).to(dev)
    w = (torch.randn((bm, 16), generator=gen) * bm ** -0.5).to(dev)
    out = dense_engine.dense_engine_matmul(x, w)
    plain = ref.dense_engine(x, w)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    exact = x.double() @ w.double()
    rel64 = ((out.double() - exact).norm() / exact.norm()).item()
    if rel64 > DENSE_REL:
        raise AssertionError(f"dense_engine mesh product: relative norm "
                             f"{rel64:.3e} vs float64 above {DENSE_REL}")
    row = _measure(out, plain,
                   lambda: dense_engine.dense_engine_matmul(x, w),
                   lambda: ref.dense_engine(x, w), lambda: torch.mm(x, w),
                   _nbytes(x, w, out), 3 * 2.0 * rows_dst * bm * 16,
                   PEAK_TF32_FLOPS)
    row.update(shape=[rows_dst, bm, 16], rel_err_f64=rel64,
               library="torch.mm",
               bound_peak="3 TF32 passes at 495 TFLOP/s dense tensor "
                          "cores, 3.35 TB/s")
    kernels["dense_engine"]["mesh_local"] = row
    print(f"kernel dense_engine, mesh row-parallel product: {row}")


def _median_forward_ms(exe, reps: int = 5) -> float:
    """Median host time of a synchronized full-graph forward, in ms."""
    exe.forward()
    times = []
    for _ in range(reps):
        _, ms = _synced(exe.forward)
        times.append(ms)
    return float(np.median(times))


def mesh_phase(dev, card: str, kernels: dict) -> dict:
    """The sharded program on a LocalMesh of data 4 x model 2 on the card
    at full-scale Pubmed (see the module docstring, 4f). Returns the
    kernel launches of its main path, the mesh serve run."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.runtime.executable import _flatten_params
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ds = make_dataset("pubmed", seed=0)
    prof = ds.profile
    mesh = make_mesh_for(MESH_RANKS, model_parallel=MESH_MODEL, device=dev)
    specs = {a: ZooSpec(a, prof.feature_dim, 16, prof.num_classes)
             for a in MESH_ARCHS}
    engines = {}
    for name, m in (("mesh", mesh), ("single", None)):
        engines[name] = GNNServeEngine(device=dev, max_shard_n=512, mesh=m)
        engines[name].register_graph("pubmed", ds)
        for arch, spec in specs.items():
            engines[name].register_model(arch, spec, seed=0)

    # the main path: requests through the Server to the mesh engine
    rng = np.random.default_rng(0)
    reqs = [NodeRequest("pubmed", rng.integers(0, prof.num_nodes, size=8),
                        model=MESH_ARCHS[i % len(MESH_ARCHS)])
            for i in range(MESH_REQUESTS)]
    server = Server(engines["mesh"], SchedulerConfig(max_batch_size=4))
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    tickets = [server.submit(r) for r in reqs]
    server.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _lib.launches()
    outcomes = [t.result() for t in tickets]
    if not all(isinstance(o, Completed) for o in outcomes):
        raise AssertionError(f"mesh serve: requests not completed: "
                             f"{outcomes}")
    want = engines["single"].serve(reqs)
    for o, w in zip(outcomes, want):
        if not np.array_equal(o.value.classes, w.classes):
            raise AssertionError(f"mesh serve {o.value.model}: classes "
                                 f"{o.value.classes} vs single-device "
                                 f"{w.classes}")
        np.testing.assert_allclose(o.value.probs, w.probs, atol=1e-5)
    # one cold forward per arch; later requests read the cached softmax
    expect = {k: sum(MESH_LAUNCHES[a].get(k, 0) for a in MESH_ARCHS)
              for k in ("shard_spmm", "fused_gnn", "dense_engine",
                        "seg_gather")}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"mesh serve launches {launches}, expected "
                             f"{expect}")
    print(f"mesh serve ({card}, Pubmed {prof.num_nodes} nodes, LocalMesh "
          f"data {mesh.n_data} x model {mesh.n_model}): {len(outcomes)} "
          f"requests in {serve_s:.3f} s (compiles "
          f"{engines['mesh'].stats['compile_ms_total']:.1f} ms), answers "
          f"equal the single-device engine's; launches {launches}")

    # the forward checks, each arch and placement
    for partition in ("contiguous", "fennel"):
        for arch in MESH_ARCHS:
            single = engines["single"].executable(arch, "pubmed")
            kw = dict(params=single.params, max_shard_n=512,
                      store=engines["mesh"].store, graph_key="pubmed",
                      mesh=mesh, partition=partition,
                      hub_cache=MESH_HUB_CACHE)
            exe = engines["mesh"].executable(arch, "pubmed") \
                if partition == "contiguous" \
                else runtime.compile(specs[arch], ds, **kw)
            logits, fwd = _launched(exe.forward)
            if fwd != MESH_LAUNCHES[arch]:
                raise AssertionError(f"mesh {arch} {partition}: a forward "
                                     f"launched {fwd}, expected "
                                     f"{MESH_LAUNCHES[arch]}")
            expect_single = single.forward()
            ref = runtime.compile(specs[arch], ds, backend="reference", **kw)
            expect_ref = ref.forward()
            err_single = (logits - expect_single).abs().max().item()
            err_ref = (logits - expect_ref).abs().max().item()
            torch.testing.assert_close(logits, expect_single, atol=1e-4,
                                       rtol=1e-4)
            torch.testing.assert_close(logits, expect_ref, atol=1e-4,
                                       rtol=1e-4)
            if not torch.isfinite(logits).all():
                raise AssertionError(f"mesh {arch}: non-finite logits")
            cs = exe.verify_comm(rtol=0.0)
            ag = cs["measured_allgather_wire_bytes"]
            ar = cs["measured_wire_bytes"].get("all-reduce", 0.0)
            if ag != MESH_ALLGATHER[partition, arch] or \
                    ar != MESH_ALLREDUCE[arch]:
                raise AssertionError(
                    f"mesh {arch} {partition}: counted all-gather {ag} / "
                    f"all-reduce {ar} wire bytes, expected "
                    f"{MESH_ALLGATHER[partition, arch]} / "
                    f"{MESH_ALLREDUCE[arch]}")
            if partition == "contiguous" and arch == "gcn":
                _mesh_kernel_rows(exe, kernels)
            plan = exe.partition
            print(f"mesh forward {arch} {partition} ({card}): vs "
                  f"single-device max_abs_err {err_single:.3e}, vs "
                  f"sharded reference {err_ref:.3e}; launches {fwd}; "
                  f"counted all-gather {ag:.0f} B (ops "
                  f"{cs['measured_allgather_ops']}), all-reduce {ar:.0f} "
                  f"B, counts {cs['measured_counts']}; cross-group edges "
                  f"{plan.cross_group_edge_frac:.4f}, caps hub "
                  f"{plan.hub_cap} halo {plan.halo_cap}, imbalance "
                  f"{plan.edge_imbalance:.3f}; partition host "
                  f"{exe.partition_host_ms:.1f} ms; forward median ms "
                  f"(host clock, synchronized) sharded "
                  f"{_median_forward_ms(exe):.3f} vs single-device "
                  f"{_median_forward_ms(single):.3f}")
            del exe, ref, logits
    for arch in ("sage_max", "gat"):
        try:
            runtime.compile(ZooSpec(arch, prof.feature_dim, 16,
                                    prof.num_classes), ds, mesh=mesh,
                            max_shard_n=512)
        except NotImplementedError:
            continue
        raise AssertionError(f"mesh {arch}: compiled, expected "
                             f"NotImplementedError")

    # data-parallel training: gcn, contiguous
    spec = specs["gcn"]
    single = engines["single"].executable("gcn", "pubmed")
    trainers = {}
    for name, m in (("mesh", mesh), ("single", None)):
        exe = runtime.compile(spec, ds, device=dev, params=single.params,
                              max_shard_n=512, mesh=m,
                              store=engines[name].store, graph_key="pubmed")
        trainers[name] = runtime.TrainableExecutable(
            exe, ds.labels, train_mask=ds.train_mask)
    tr = trainers["mesh"]
    batch = tr.data(0)
    (loss, _, grads), step = _launched(
        lambda: tr.loss_and_grads(tr.params, batch))
    if step != MESH_LAUNCHES["gcn"]:
        raise AssertionError(f"mesh train: a step launched {step}")
    trs = trainers["single"]
    loss_s, _, grads_s = trs.loss_and_grads(trs.params, trs.data(0))
    ours, theirs = (_flatten_params(g) for g in (grads, grads_s))
    rels = {k: float(np.linalg.norm(ours[k] - g) / max(np.linalg.norm(g),
                                                       1e-30))
            for k, g in theirs.items()}
    if max(rels.values()) > GRAD_REL:
        raise AssertionError(f"mesh train: step-0 gradients vs "
                             f"single-device, relative norms {rels}")
    t0 = time.perf_counter()
    res = runtime.fit(spec, ds, steps=MESH_TRAIN_STEPS, lr=TRAIN_LR,
                      device=dev, params=single.params, max_shard_n=512,
                      mesh=mesh, store=engines["mesh"].store,
                      log_every=1, log=lambda line: None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = [x for _, x in res.history]
    if len(losses) != MESH_TRAIN_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"mesh fit: losses {losses}")
    tcs = res.trainable.verify_train_comm()
    step_ms = []
    for _ in range(3):
        _, ms = _synced(lambda: tr.step_fn(tr.params, tr.opt_state, batch))
        step_ms.append(ms)
    print(f"mesh train gcn ({card}): step-0 loss {loss.item():.6f} "
          f"(single-device {loss_s.item():.6f}), gradient relative norms "
          f"max {max(rels.values()):.3e} (limit {GRAD_REL}); step launches "
          f"{step}; fit {MESH_TRAIN_STEPS} steps in {fit_s:.3f} s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; train step collectives "
          f"{tcs['measured_counts']} wire "
          f"{ {k: int(v) for k, v in tcs['measured_wire_bytes'].items()} }; "
          f"step median {float(np.median(step_ms)):.3f} ms (host clock, "
          f"synchronized)")
    del trainers, tr, trs, res, engines, server, single
    gc.collect()
    torch.cuda.empty_cache()

    _mesh_stream(dev, card, mesh, specs["gcn"])
    torch.cuda.synchronize()
    print(f"mesh phase wall time ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_stream(dev, card: str, mesh, spec) -> None:
    """Streaming on the mesh: a mutable fennel gcn engine and a mutable
    contiguous one take ``MESH_DELTAS`` deltas each through
    ``Server.mutate`` (``random_delta``, seed 0), every one in template;
    then fennel's logits are held to a fresh single-device compile of the
    post-delta graph (1e-4), contiguous's to a fresh sharded compile
    (bitwise)."""
    from repro_torch import runtime
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
    from repro_torch.stream import random_delta

    for partition in ("fennel", "contiguous"):
        ds = make_dataset("pubmed", seed=0)      # each engine mutates its own
        engine = GNNServeEngine(device=dev, max_shard_n=512, mesh=mesh,
                                partition=partition,
                                hub_cache=MESH_HUB_CACHE, streaming=True)
        engine.register_graph("pubmed", ds)
        engine.register_model("gcn", spec, seed=0)
        server = Server(engine, SchedulerConfig(max_batch_size=4))
        rng = np.random.default_rng(0)
        ticket = server.submit(NodeRequest("pubmed", np.arange(8), "gcn"))
        server.drain()
        if not isinstance(ticket.result(), Completed):
            raise AssertionError(f"mesh stream: {ticket.result()}")
        exe = engine.executable("gcn", "pubmed")
        caps = (exe.partition.hub_cap, exe.partition.halo_cap)
        walls = []
        for _ in range(MESH_DELTAS):
            delta = random_delta(ds, rng, edge_ops=STREAM_EDGE_OPS,
                                 p_node=STREAM_P_NODE)
            rep, wall = _synced(lambda: server.mutate("pubmed", delta))
            walls.append(wall)
            if any(m.get("recompile") for m in rep["executables"]):
                raise AssertionError(f"mesh stream {partition}: a delta "
                                     f"left the template: {rep}")
        if engine.executable("gcn", "pubmed") is not exe or \
                engine.stats["graph_recompiles"]:
            raise AssertionError(f"mesh stream {partition}: recompiled")
        logits = exe.forward()
        kw = dict(device=dev, params=engine.model_params("gcn"),
                  max_shard_n=512, store=runtime.GraphStore())
        if partition == "fennel":
            fresh = runtime.compile(spec, ds, **kw).forward()
            err = (logits - fresh).abs().max().item()
            torch.testing.assert_close(logits, fresh, atol=1e-4, rtol=1e-4)
            verdict = f"vs a fresh single-device compile max_abs_err {err:.3e}"
        else:
            fresh = runtime.compile(spec, ds, mesh=mesh, **kw).forward()
            if not torch.equal(logits, fresh):
                raise AssertionError(
                    f"mesh stream contiguous: logits differ from a fresh "
                    f"sharded compile by "
                    f"{(logits - fresh).abs().max().item():.3e}")
            verdict = "bitwise equal to a fresh sharded compile"
        print(f"mesh stream {partition} ({card}): {MESH_DELTAS} deltas in "
              f"template (caps hub/halo {caps} -> "
              f"{(exe.partition.hub_cap, exe.partition.halo_cap)}), "
              f"synchronized mutate ms {[round(w, 1) for w in walls]} "
              f"(re-partition host {exe.partition_host_ms:.1f} ms last); "
              f"{ds.profile.num_nodes} nodes after; post-delta logits "
              f"{verdict}")
        del engine, server, exe, logits, fresh
        gc.collect()
        torch.cuda.empty_cache()


def analyze_phase(dev, card: str) -> dict:
    """The analysis passes on the card at full-scale Pubmed (see the
    module docstring, 4g). Returns the kernel launches of its main path,
    the five archs' probes."""
    import importlib
    import threading

    from repro_torch import runtime
    from repro_torch.analyze import (analyze_executable, lock_sanitizer,
                                     op_lint)
    from repro_torch.gnn.models import ZooSpec, graph_signature
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.graphs.patch import PatchState, fullest_pair_insert
    from repro_torch.kernels import _lib, csr
    from repro_torch.launch import analyze as analyze_cli
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
    from repro_torch.stream import random_delta

    fwd = importlib.import_module("repro_torch.runtime.forward")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ds = make_dataset("pubmed", seed=0)
    prof = ds.profile
    specs = {a: ZooSpec(a, prof.feature_dim, 16, prof.num_classes,
                        num_layers=2, heads=2) for a in ARCHS}
    rules, passes, timings, reports = {}, {}, {}, []
    launches = dict.fromkeys(_lib.KERNELS, 0)

    # the main path: each arch compiled with analyze="error", then probed
    # (forwards, node batches, two mutation deltas) through the kernels
    store = runtime.GraphStore()
    gts: list = []
    real_forward = fwd.forward

    def counted(spec, params, gt, h, **kw):
        gts.append(gt)
        return real_forward(spec, params, gt, h, **kw)

    exes = {}
    for arch, spec in specs.items():
        exe, compile_ms = _synced(lambda: runtime.compile(
            spec, ds, device=dev, backend="cuda", max_shard_n=512,
            mutable_graph=True, store=store, analyze="error"))
        exes[arch] = exe
        reports.append(exe.analysis)
        gts.clear()
        fwd.forward = counted
        try:
            torch.cuda.synchronize()
            _lib.reset_launches()
            csr.reset_index_builds()
            rep, probe_ms = _synced(
                lambda: analyze_executable(exe, probe=True, graph=ds))
            got = {k: v for k, v in _lib.launches().items() if v}
            builds = csr.index_builds()
        finally:
            fwd.forward = real_forward
        reports.append(rep)
        if rep.failed("error"):
            raise RuntimeError(f"analyze {arch}: {rep.render()}")
        forwards, graphs = len(gts), len({id(g) for g in gts})
        gts.clear()
        want = {k: v * forwards for k, v in FORWARD_LAUNCHES[arch].items()}
        if got != want:
            raise RuntimeError(f"analyze {arch}: the probe's {forwards} "
                               f"forwards launched {got}, expected {want}")
        if any(v > graphs for v in builds.values()):
            raise RuntimeError(f"analyze {arch}: {builds} index builds for "
                               f"{graphs} GraphTensors")
        for k, v in got.items():
            launches[k] += v
        for name, ms in rep.timings_ms.items():
            timings.setdefault(name, []).append(ms)
        plain_ms = float(np.median([_synced(exe.forward)[1]
                                    for _ in range(5)]))
        with torch.inference_mode():
            _, mode_ms = _synced(lambda: op_lint.dtype_findings(
                exe._forward_fn(), (exe.params, exe._h_grouped), name=arch))
        print(f"analyze {arch} ({card}): compile(analyze='error') "
              f"{compile_ms:.1f} ms; probe {probe_ms:.1f} ms, "
              f"{forwards} forwards on {graphs} graphs, launches {got}, "
              f"index builds {builds}; findings "
              f"{[f.rule for f in rep.findings] or 'none'}; forward under "
              f"the dtype recorder {mode_ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms (median of 5) (host clock, synchronized)")

    # negative controls: each must fire
    gcn = exes["gcn"]
    wide = op_lint.dtype_findings(
        lambda p, h: gcn._forward_fn()(p, h.double().float()),
        (gcn.params, gcn._h_grouped), name="gcn[.double()]")
    if "DT001" not in {f.rule for f in wide}:
        raise RuntimeError(f"DT001 did not fire on a .double() forward: "
                           f"{wide}")
    del exes, gcn
    store.evict()
    frozen = runtime.compile(specs["gcn"], ds, device=dev, backend="cuda",
                             max_shard_n=512, store=runtime.GraphStore())
    norm, loops = graph_signature("gcn")
    ps = PatchState(ds.edges, prof.num_nodes, frozen.gt.n, normalize=norm,
                    add_self_loops=loops,
                    edge_capacity=int(frozen.gt.edge_src.shape[-1]))
    grow = op_lint.check_mutation_stability(
        frozen, ds.edges, prof.num_nodes, [fullest_pair_insert(ps)],
        name="Executable[gcn,frozen]")
    if [f.rule for f in grow] != ["RT003"]:
        raise RuntimeError(f"RT003 did not fire on a frozen template: "
                           f"{grow}")
    del frozen, ps
    with lock_sanitizer.sanitize() as san:
        a, b = lock_sanitizer.new_lock("A"), lock_sanitizer.new_lock("B")
        for first, second in ((a, b), (b, a)):
            def take(first=first, second=second):
                with first:
                    with second:
                        pass
            t = threading.Thread(target=take)
            t.start()
            t.join()
    if [f.rule for f in san.findings()] != ["LS001"]:
        raise RuntimeError(f"LS001 did not fire: {san.findings()}")
    print(f"analyze negative controls ({card}): DT001 "
          f"{sum(f.rule == 'DT001' for f in wide)}, RT003 {len(grow)}, "
          f"LS001 1 — each fired")
    gc.collect()
    torch.cuda.empty_cache()

    # the Server preflight, then a streaming loop, all under the sanitizer
    live = make_dataset("pubmed", seed=0)
    rng = np.random.default_rng(0)

    def request(arch):
        return NodeRequest("pubmed", rng.integers(0, prof.num_nodes, size=8),
                           model=arch)

    with lock_sanitizer.sanitize() as san:
        engine = GNNServeEngine(device=dev, backend="cuda", max_shard_n=512,
                                streaming=True)
        engine.register_graph("pubmed", live)
        for arch, spec in specs.items():
            engine.register_model(arch, spec, seed=0)
        server = Server(engine, SchedulerConfig(max_batch_size=4))
        tickets = [server.submit(request(a)) for a in ARCHS]
        server.drain()
        _, start_ms = _synced(lambda: server.start(analyze="error"))
        tickets += [server.submit(request(a)) for a in ARCHS]
        mutate_ms = []
        for _ in range(10):
            tickets += [server.submit(request(a)) for a in ARCHS]
            _, ms = _synced(lambda: server.mutate(
                "pubmed", random_delta(live, rng, edge_ops=8)))
            mutate_ms.append(ms)
        outcomes = [t.result(timeout_s=300.0) for t in tickets]
        server.stop()
    bad = [o for o in outcomes if not isinstance(o, Completed)]
    if bad:
        raise RuntimeError(f"analyze serve: {len(bad)} of {len(outcomes)} "
                           f"requests did not complete: {bad[:3]}")
    lock = san.findings()
    if any(f.rule == "LS001" for f in lock):
        raise RuntimeError(f"lock sanitizer: {san.report().render()}")
    print(f"analyze serve ({card}): Server.start(analyze='error') "
          f"{start_ms:.1f} ms (preflight over {len(ARCHS)} executables); "
          f"{len(outcomes)} requests completed; 10 deltas through "
          f"Server.mutate, median {float(np.median(mutate_ms)):.1f} ms; "
          f"lock sanitizer {san.acquisitions} acquisitions, no LS001")
    for f in lock:
        print(f"analyze lock sanitizer: {f.rule} {f.location}: {f.message}")
    del engine, server, live
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI gate on the card
    rc, cli_ms = _synced(lambda: analyze_cli.main(
        ["--fail-on", "error", "--backend", "cuda"]))
    if rc != 0:
        raise RuntimeError(f"launch.analyze --backend cuda exited {rc}")
    for f in (f for rep in reports for f in rep.findings):
        rules[f.rule] = rules.get(f.rule, 0) + 1
        passes[f.pass_name] = passes.get(f.pass_name, 0) + 1
    print(f"analyze findings ({card}): by rule {rules or 'none'}, by pass "
          f"{passes or 'none'}; timings_ms per pass (the five probes) "
          f"{ {k: [round(x, 1) for x in v] for k, v in timings.items()} }; "
          f"CLI gate {cli_ms:.0f} ms, exit 0")
    torch.cuda.synchronize()
    print(f"analyze phase wall time ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _attention_pairs(sq: int, skv: int) -> int:
    """(q, k) pairs a causal mask keeps: row i sees keys 0 .. Skv - Sq + i."""
    seen = np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv)
    return int(seen.sum())


def attention_kernel_phase(dev, results: dict) -> None:
    """flash_attention's two kernels against the plain version: the
    tensor-core kernel (bf16) at the LM prefill shapes, at Sq < Skv and at
    a ragged S; the CUDA-core kernel (f32) at S 2048 and Sq < Skv. Both
    kernels (the CUDA-core one on bf16 and f32 inputs), the plain version
    and ``scaled_dot_product_attention`` are timed at both prompt
    lengths."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _launch, _route
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(dev).manual_seed(0)
    b, hq, hkv, dh = 4, 32, 8, 128
    s = max(LM_PROMPTS)
    if _route(torch.bfloat16, dh) != "flash_attention_tc":
        raise AssertionError("bf16 at dh 128 is not routed to the "
                             "tensor-core kernel")

    def qkv(sq, skv, dtype):
        return (torch.randn((b, hq, sq, dh), generator=gen, device=dev).to(dtype),
                torch.randn((b, hkv, skv, dh), generator=gen, device=dev).to(dtype),
                torch.randn((b, hkv, skv, dh), generator=gen, device=dev).to(dtype))

    errs, rels = {}, {}
    cases = [(torch.bfloat16, sq, skv) for sq, skv in
             ((s, s), (min(LM_PROMPTS), min(LM_PROMPTS)), (s // 4, s),
              (2000, 2000))]
    cases += [(torch.float32, s, s), (torch.float32, s // 4, s)]
    for dtype, sq, skv in cases:
        q, k, v = qkv(sq, skv, dtype)
        out = flash_attention(q, k, v, causal=True)
        plain = ref.flash_attention(q, k, v, causal=True)
        errs[(dtype, sq, skv)], rels[(dtype, sq, skv)] = _attention_check(
            f"flash_attention {str(dtype)[6:]} ({_route(dtype, dh)}) q "
            f"{tuple(q.shape)} kv {tuple(k.shape)}", out, plain, dtype)
        del q, k, v, out, plain

    timings, cuda_core_bf16 = {}, {}
    for plen in LM_PROMPTS:
        q, k, v = qkv(plen, plen, torch.bfloat16)
        f32 = tuple(t.float() for t in (q, k, v))
        # the CUDA-core kernel on the bf16 inputs it is timed on
        cuda_core_bf16[plen] = _attention_check(
            f"flash_attention bfloat16 (flash_attention, forced) q "
            f"{tuple(q.shape)} kv {tuple(k.shape)}",
            _launch("flash_attention", q, k, v, causal=True),
            ref.flash_attention(q, k, v, causal=True), torch.bfloat16)
        row = {
            "tc_ms": _ms(lambda: flash_attention(q, k, v, causal=True)),
            "cuda_core_bf16_ms": _ms(lambda: _launch(
                "flash_attention", q, k, v, causal=True)),
            "cuda_core_f32_ms": _ms(lambda: flash_attention(*f32,
                                                            causal=True)),
            "sdpa_ms": _ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
            "bound_ms": _bound(_nbytes(q, k, v, q),
                               4.0 * dh * _attention_pairs(plen, plen)
                               * b * hq, PEAK_BF16_FLOPS)[0]}
        timings[plen] = row
        print(f"flash_attention timings at {b}x{plen} (bf16 unless noted): "
              + ", ".join(f"{key} {val:.3f}" for key, val in row.items()))
        del q, k, v, f32

    q, k, v = qkv(s, s, torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    plain = ref.flash_attention(q, k, v, causal=True)
    library = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
    pairs = _attention_pairs(s, s)
    _record(results, "flash_attention", _measure(
                out, plain,
                lambda: flash_attention(q, k, v, causal=True),
                lambda: ref.flash_attention(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                _nbytes(q, k, v, out), 4.0 * dh * pairs * b * hq,
                PEAK_BF16_FLOPS),
            source="flash_attention_tc",
            launch_counter="flash_attention_tc",
            shape={"b": b, "hq": hq, "hkv": hkv, "sq": s, "skv": s, "dh": dh,
                   "dtype": "bfloat16", "causal": True},
            bound_peak="989 TFLOP/s dense bf16 tensor cores, 3.35 TB/s",
            timings_by_prompt=timings,
            cuda_core_route={
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "launch_counter": "flash_attention",
                "f32_max_abs_err": errs[(torch.float32, s, s)],
                "f32_cross_max_abs_err": errs[(torch.float32, s // 4, s)],
                "f32_rel_err": rels[(torch.float32, s, s)],
                "f32_cross_rel_err": rels[(torch.float32, s // 4, s)],
                "bf16_errs_by_prompt": {
                    plen: {"max_abs_err": e, "rel_err": r}
                    for plen, (e, r) in cuda_core_bf16.items()}},
            rel_err=rels[(torch.bfloat16, s, s)],
            max_abs_err_by_shape={f"{sq}x{skv}": e for (dt, sq, skv), e
                                  in errs.items() if dt == torch.bfloat16},
            rel_err_by_shape={f"{sq}x{skv}": e for (dt, sq, skv), e
                              in rels.items() if dt == torch.bfloat16},
            rel_tol=ATTN_REL[torch.bfloat16],
            library_max_abs_err=(library.float() - plain.float())
            .abs().max().item())


def lm_serve_phase(card: str) -> int:
    """Serve qwen3-8b at full width through the Server; return the
    tensor-core flash_attention launches of that run."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import (build_lm_engine, drive_lm,
                                          latency_percentiles, lm_report,
                                          lm_requests, parser)
    from repro_torch.serving import Completed

    args = parser().parse_args(
        ["--mode", "lm", "--arch", LM_ARCH, "--no-smoke",
         "--prompt-len", str(max(LM_PROMPTS)),
         "--new-tokens", str(LM_NEW_TOKENS), "--batch-size", "4"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_lm_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    leaves = [engine.params["embed"], engine.params["final_norm"],
              engine.params["lm_head"]]
    for layer in engine.params["layers"]:
        for part in layer.values():
            leaves.extend(part.values() if isinstance(part, dict) else [part])
    n_params = sum(t.numel() for t in leaves)
    if n_params != cfg.num_params():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.num_params()}")
    print(f"lm setup: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
          f"{n_params / 1e9:.3f} B params, "
          f"{_nbytes(*leaves) / 1e9:.2f} GB {cfg.param_dtype}, drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s; max_len {engine.max_len}")

    requests = [r for i, plen in enumerate(LM_PROMPTS)
                for r in lm_requests(cfg, LM_REQUESTS_PER_PROMPT, plen,
                                     LM_NEW_TOKENS, seed=1 + i)]
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    server, outcomes = drive_lm(engine, requests, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _lib.launches()
    done = [o for o in outcomes if isinstance(o, Completed)]
    if len(done) != len(requests):
        raise AssertionError(f"only {len(done)}/{len(requests)} LM requests "
                             f"completed: {outcomes}")
    for o in done:
        toks = o.value
        if toks.shape != (LM_NEW_TOKENS,) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"bad generated tokens {toks}")
    batches = engine.stats["prefill_batches"]
    expect = cfg.n_layers * batches
    p50, p95, p99 = latency_percentiles(outcomes)
    print(server.report())
    print(f"lm serve ({card}): {len(done)}/{len(requests)} requests, "
          f"{sum(len(o.value) for o in done)} tokens in {wall:.3f} s | "
          f"{lm_report(engine)} | latency p50 {p50:.3f} ms, p95 {p95:.3f} "
          f"ms, p99 {p99:.3f} ms | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"lm serve: kernel launches {launches}")
    if batches != len(LM_PROMPTS) or launches["flash_attention_tc"] \
            != expect or launches["flash_attention"]:
        raise AssertionError(
            f"flash_attention_tc launched {launches['flash_attention_tc']} "
            f"times (the CUDA-core kernel {launches['flash_attention']}) "
            f"over {batches} prefill batches; expected {cfg.n_layers} per "
            f"batch over {len(LM_PROMPTS)} batches, all on the tensor cores")

    lm_prefill_parity(engine, requests, done, card)
    lm_profile(engine, requests[-LM_REQUESTS_PER_PROMPT:], card)
    return launches["flash_attention_tc"]


def lm_prefill_parity(engine, requests, served, card: str) -> None:
    """Time each prompt length's batch through both backends; the shorter
    batch's last-position logits must agree within the stated tolerance,
    and its served first tokens must be their argmax."""
    from repro_torch.models import lm

    cfg, n = engine.cfg, LM_REQUESTS_PER_PROMPT
    prefill_ms, logits = {}, {}
    for i, plen in enumerate(LM_PROMPTS):
        toks = torch.from_numpy(np.stack(
            [r.prompt for r in requests[i * n:(i + 1) * n]])).to(engine.device)
        for backend in ("cuda", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                out, _ = lm.prefill(engine.params, cfg, {"tokens": toks},
                                    engine.max_len, backend=backend)
            torch.cuda.synchronize()
            prefill_ms[(plen, backend)] = (time.perf_counter() - t0) * 1e3
            if i == 0:
                logits[backend] = out[:, 0].float()
            del out
    print(f"lm prefill ({card}, host clock, synchronized): " + ", ".join(
        f"{n}x{plen} {backend} {ms:.3f} ms"
        for (plen, backend), ms in prefill_ms.items()))
    got, exp = logits["cuda"], logits["reference"]
    if got.shape != (n, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite "
                             f"or of the wrong shape")
    err = (got - exp).abs().max().item()
    rel = ((got - exp).norm() / exp.norm()).item()
    top1 = (got.argmax(-1) == exp.argmax(-1)).float().mean().item()
    print(f"lm parity ({LM_ARCH}, {n} x {LM_PROMPTS[0]} prompt tokens, "
          f"{cfg.param_dtype}): cuda vs reference prefill logits max_abs_err "
          f"{err:.4e} (tol {LM_LOGIT_ATOL}), rel norm {rel:.4e} (tol "
          f"{LM_LOGIT_REL}), top-1 agreement {top1:.2f}, |logit| max "
          f"{exp.abs().max().item():.3f}")
    if err > LM_LOGIT_ATOL or rel > LM_LOGIT_REL:
        raise AssertionError("cuda prefill logits disagree with the "
                             "reference backend")
    served_first = np.array([o.value[0] for o in served[:n]])
    if not (served_first == got.argmax(-1).cpu().numpy()).all():
        raise AssertionError("served first tokens differ from the argmax "
                             "of the same prefill")


def _profile(fn, label: str, card: str) -> None:
    """Run ``fn`` once under ``torch.profiler``; print wall time, the
    summed kernel time (the device's busy time: one stream), the idle
    share, the kernel launch count and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if not kernels:
        print(f"profile {label}: wall {wall_ms:.3f} ms; device time not "
              f"measured (the profiler saw no kernels)")
        return
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    print(f"profile {label} ({card}, under the profiler): wall "
          f"{wall_ms:.3f} ms, kernels {busy_ms:.3f} ms over {launches} "
          f"launches, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def lm_profile(engine, batch, card: str) -> None:
    """Profile one prefill of ``batch`` and one decode step after it."""
    from repro_torch.models import lm

    toks = torch.from_numpy(np.stack([r.prompt for r in batch])).to(
        engine.device)
    state = {}

    def prefill():
        state["logits"], state["caches"] = lm.prefill(
            engine.params, engine.cfg, {"tokens": toks}, engine.max_len)

    def decode():
        nxt = state["logits"][:, 0].argmax(-1)[:, None]
        lm.decode_step(engine.params, engine.cfg,
                       {"tokens": nxt, "pos": toks.shape[1]},
                       state["caches"])

    with torch.inference_mode():
        _profile(prefill, f"lm prefill {toks.shape[0]}x{toks.shape[1]}",
                 card)
        _profile(decode, f"lm decode step (batch {toks.shape[0]})", card)


def main() -> None:
    card = device_check()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_engine, parser

    build(_lib)
    args = parser().parse_args(
        ["--mode", "gnn", "--graphs", "pubmed", "--models", ",".join(ARCHS),
         "--scale", "1.0", "--hidden", "16", "--layers", "2",
         "--shard-n", "512", "--num-requests", "48"])
    t0 = time.perf_counter()
    engine, datasets = build_engine(args)
    ds = datasets["pubmed"]
    print(f"setup: engine + Pubmed in {time.perf_counter() - t0:.1f} s")
    kernels = kernel_phase(engine, ds)
    launches = serve_phase(engine, ds, args, kernels)
    train_launches = train_phase(engine, ds, card)
    for name, row in kernels.items():
        row["launches"] = launches[name]
    dev, max_shard_n = engine.device, engine.max_shard_n
    del engine, datasets
    gc.collect()
    torch.cuda.empty_cache()
    minibatch_phase(ds, dev, card, max_shard_n)
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    stream_launches = stream_phase(dev, card, max_shard_n)
    tune_launches = tune_phase(dev, card)
    mesh_launches = mesh_phase(dev, card, kernels)
    analyze_launches = analyze_phase(dev, card)

    attention_kernel_phase(torch.device("cuda"), kernels)
    kernels["flash_attention"]["launches"] = lm_serve_phase(card)
    for name, row in kernels.items():       # every row, flash_attention's too
        row["train_step_launches"] = train_launches.get(name, 0)
        row["stream_launches"] = stream_launches.get(name, 0)
        row["tune_launches"] = tune_launches.get(name, 0)
        row["mesh_launches"] = mesh_launches.get(name, 0)
        row["analyze_launches"] = analyze_launches.get(name, 0)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
