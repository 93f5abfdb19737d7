#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it,
and fails (non-zero exit, no result line) without them, or when a
``REPRO_KERNEL_BACKEND*`` variable is set (it would route ops away from
the kernels). Device memory:
~6.4 GB of Pubmed block grids for serving and as much again for training
(the stream phase: as much for its engine, a transient clone per patch
and a fresh build to compare with), 6.7 GB of reddit grids in phase 4h,
6.4 GB of Pubmed grids, a 1.6 GB flat adjacency and up to ~10 GB of
oracle temporaries in phase 4i, then (after they are freed) 16.4 GB of qwen3-8b weights plus ~1.2 GB of
KV cache and a few GB of plain-attention scratch, 5.4 GB of minicpm-2b,
then ~38 GB of command-r-plus-104b at 8 layers, 28.6 GB of
qwen2-moe-a2.7b (38 GB at its peak), 39.4 GB of llama4-scout-17b-a16e at
8 layers (57 GB at its peak, in the float64 MoE check), 5.8 GB of
recurrentgemma-2b and 2.7 GB of mamba2-1.3b, then 3.1 GB of qwen2-vl-2b,
4.9 GB of musicgen-large, ~37 GB of qwen2.5-3b's train state (bf16
parameters and gradients, float32 moments) and ~25 GB of qwen2-vl-2b's
(with the float32 error feedback); the train phase also writes a ~31 GB
checkpoint to a temporary directory on the host. In order:

1. device check: the backend variables unset; prints ``nvidia-smi``'s
   name and power limit; TF32 off;
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
4h. paper networks phase (its own graphs, freed before the LM phases):
   ``repro_torch.core.models`` gcn, graphsage and graphsage_pool
   (``paper_spec``, hidden 16, ``init_gnn`` on the card, shard n 512) on
   full-scale Pubmed and on reddit x ``REDDIT_SCALE`` (23,296 nodes,
   11,461,588 edges, 602 features, 41 classes; S 46, 2.22 GB of blocks a
   signature). Each network: logits within 1e-4 of the same
   ``make_forward`` on a controller pinned to ``reference``, launches per
   forward and per masked cross-entropy step exactly ``PAPER_LAUNCHES``,
   every gradient finite, nonzero and within ``GRAD_REL`` of the
   reference backend's; the median synchronized forward printed. On
   Pubmed: sage_max's gathers routed to ``reference`` by ``op_backends=``
   and by ``REPRO_KERNEL_BACKEND_GATHER_AGGREGATE`` (0 seg_gather, 4
   dense_engine, logits within 1e-4 of the all-cuda compile), an explicit
   ``backend="cuda"`` over that variable launching the kernels, gat's
   heads routed off shard_spmm; two standalone gcn compiles sharing one
   ``default_store()`` build, and ``evict()`` freeing it. On reddit:
   the host build's times (generator, ``shard_graph``, upload), and the
   four GNN kernels against their plain versions at layer 0 (D 602),
   timed beside their bound and a library call (``reddit`` on each
   kernel row), and each network's cuda logits held to the
   dense-adjacency oracles as in phase 4i (the reddit flat adjacency is
   2.22 GB). Printed: the phase's wall time and peak device memory;
4i. dense oracles phase (its own graphs, freed before the LM phases),
   TF32 off (``env.pinned()``): the five archs compiled with the ``cuda``
   backend on full-scale Pubmed as phase 4 (hidden 16, 2 layers, gat 2
   heads, shard n 512); each ``Executable.forward`` launches exactly
   ``FORWARD_LAUNCHES`` and its logits are held to ``kernels/ref.py``'s
   dense-adjacency layer oracles (``gcn_layer`` ... ``gat_layer``) run on
   the executable's own blocks flattened to (19,968, 19,968) (1.6 GB),
   within atol = rtol = ``ORACLE_TOL``; the oracles launch no kernel. The
   max-pool and gat oracles take destination rows in chunks of
   ``ref.ORACLE_CHUNK_BYTES``. Then the five torch examples
   (``EXAMPLE_RUNS``) as subprocesses on the card, all started together,
   each within ``EXAMPLE_TIMEOUT_S``: each exits 0; quickstart prints its
   accuracies, serve_gnn completes every request, the dataflow
   explorer's report equals the same report computed on the host (its
   ``main`` run here with ``--device cpu``, the Executable header apart),
   train_lm's final loss is below the uniform log V. Printed: the
   max abs error and relative norm per arch, each example's time, the
   phase's wall time and peak device memory (this process's);
5. attention kernel phase: flash_attention's two kernels against the
   plain version: the tensor-core kernel (the bf16 route) at the LM
   path's prefill shapes (B 4, Hq 32, Hkv 8, S 1024 and 2048, dh 128,
   causal), at an Sq < Skv shape and at a ragged S 2000 (8e-2 max abs,
   5e-3 relative norm); the CUDA-core kernel (the float32 route) at S
   2048 and Sq < Skv (2e-4, 1e-5), and on the bf16 inputs it is timed on
   (8e-2, 5e-3). Both kernels, the CUDA-core one also on the bf16
   inputs, are timed beside the plain version and
   ``scaled_dot_product_attention`` at both prompt lengths; the
   tensor-core kernel also at minicpm-2b's MHA shape (B 4, 36/36 heads,
   dh 64, S 1024 and 2048; 8e-2, 5e-3), timed beside the plain version,
   SDPA and its bound (``dh64_mha``); the tensor-core kernel at
   recurrentgemma-2b's local attention (B 4, MQA 10/1, dh 256, window
   2048; S 1024, 2048, 4096 and Sq 512 < Skv 2048) in bf16 (8e-2, 5e-3),
   the CUDA-core kernel forced on the same bf16 inputs (8e-2, 5e-3) and
   in float32, its route (2e-4, 1e-5); at each Sq == Skv both kernels
   timed beside the plain version, SDPA with the banded mask, SDPA with
   ``is_causal`` (S <= window) and the bound (``dh256_mqa_window``). At
   S 2048 (dh 128 and dh 256) the tensor-core kernel's relative error is
   printed against the plain version (float32 P, as the Pallas kernel)
   and against the same computation rounding P to bf16 (as the kernel
   does for wgmma) (``p_rounding``);
6. LM serve phase: qwen3-8b at full width (bf16, random weights from a
   seed) behind the Server (max batch 4): 4 requests with 1024-token and 4
   with 2048-token prompts, 16 new tokens each, greedy; all must complete,
   the tensor-core flash_attention kernel must launch once per layer per
   prefill batch (and the CUDA-core one never), and one
   batch's prefill logits must match the ``reference`` backend within
   ``LM_LOGIT_ATOL``; each batch's prefill is timed on both backends, and
   one prefill and one decode step are traced with ``torch.profiler``
   (kernel time, launches, idle share); then minicpm-2b at full width and
   depth (4 requests of 1024 prompt tokens, 16 new tokens; its logits
   within ``MINICPM_LOGIT_ATOL``), then command-r-plus-104b at full width
   and ``COMMAND_R_LAYERS`` of 64 layers (2 requests of 1024 tokens, one
   prefill batch and 4 decode steps), then qwen2-moe-a2.7b at full width
   and depth (4 x 1024, 16 new, one request at ``SAMPLE_TEMPERATURE``:
   its batch must repeat token for token from the same engine seed),
   llama4-scout-17b-a16e at full width and ``LLAMA4_LAYERS`` of 48 layers
   (2 x 1024, 5 new), recurrentgemma-2b (4 x 1024 and 4 x 2048, 16 new:
   shorter than and equal to its 2048 window, decode wraps the ring
   buffer) and mamba2-1.3b (4 x 1024, 16 new), each with the same launch
   checks (one flash_attention per attention layer per prefill batch, on
   the kernel ``_route`` picks: ``_tc`` in bf16 at dh 64, 128 and 256
   (recurrentgemma's), none for mamba2), its parameter count
   (``num_params()`` plus the conv biases it leaves out) and parity (the
   MoE models against the reference run with the cuda run's routing
   replayed, the free-running routing agreement per layer printed). The
   last four also hold the RG-LRU scan, the chunked SSD and the MoE
   dispatch and combine of one full-width layer to float64
   (``RGLRU_REL``, ``SSD_REL``, ``MOE_REL``; the MoE one with a row that
   overflows every capacity it uses), and prefill + one decode step to
   the full forward (``LM_LOGIT_ATOL``; MoE at no-drop capacity with the
   forward's routing replayed). Each model is freed after, its wall time
   and peak memory printed; qwen3-8b and the last four are profiled;
6a. VLM serve: qwen2-vl-2b at full width and depth through
   ``lm.prefill`` and ``lm.decode_step`` (the engine serves token inputs
   only, as the reference's): ``VLM_BATCH`` prompts of 1024 frontend
   embedding rows under Qwen2-VL's M-RoPE ids (``VLM_GRID``: text, a 28
   x 32 image grid, text), prefill timed cold and warm, 16 decode steps;
   28 ``_tc`` launches a prefill and no CUDA-core one; prefill logits
   against the ``reference`` backend and prefill + one decode step
   against the full forward (its last ids (s, s, s)) within
   ``LM_LOGIT_ATOL`` and ``LM_LOGIT_REL``; degenerate ids must move the
   logits by more than ``LM_LOGIT_ATOL``; one prefill and one decode
   step profiled;
6b. audio serve: musicgen-large at full width and depth through the
   Server (max batch 4), 4 requests of (1024, 4) codebook prompts, 16 new
   tokens, one at ``SAMPLE_TEMPERATURE`` (its batch repeats token for
   token from the same engine seed); every request (16, 4) tokens; 48
   ``_tc`` launches a prefill batch; parity and profile as in phase 6;
6c. LM train: qwen2.5-3b at full width and depth, ``make_train_step``
   (remat, donating) under ``TrainLoop`` on ``TRAIN_LM_BATCH`` tokens.
   Step-0 loss and gradients against the ``reference`` backend
   (``LM_LOSS_ATOL``; every leaf within ``LM_GRAD_REL``, the worst five
   printed) and, at ``TRAIN_F32_LAYERS`` layers in float32 through the
   CUDA-core kernel, within ``GRAD_REL``; ``TRAIN_LM_STEPS`` steps on one
   batch at lr ``TRAIN_LM_LR``: finite losses, the last below the first,
   exactly 72 ``_tc`` launches a step (each attention layer's forward
   and its remat recompute) and none on the CUDA-core kernel; the AdamW
   update's share of a step; one step profiled; a SIGTERM after step
   ``TRAIN_CKPT_STEP`` saved by the loop (async ``CheckpointManager`` in
   a temporary directory) and a new ``TrainLoop`` that restores it: the
   restored state bit for bit the saved one and the resumed step equal
   to the uninterrupted run's (loss and state, exactly);
6d. LM train with compression: qwen2-vl-2b at full width and depth,
   ``compress_grads=True``, ``VLM_TRAIN_STEPS`` steps on embedding
   batches under ``VLM_TRAIN_GRID``'s ids: step-0 gradients within
   ``LM_GRAD_REL`` of ``reference``, finite losses, the error feedback
   nonzero after step 1, 56 ``_tc`` launches a step, the wire bytes
   saved printed;
6e. scanned forward: recurrentgemma-2b at full width and depth
   restacked into 8 groups of 3 layers and 2 trailing layers;
   ``forward_scanned`` against ``forward`` and ``loss_fn_scanned``
   against ``loss_fn`` on ``SCAN_BATCH`` tokens within ``SCAN_ATOL``;
   one tensor-core flash_attention launch per attention layer per pass
   and none on the CUDA-core kernel;
7a. sharded train: phase 6c's qwen2.5-3b step (seed 0, its batch, remat,
   donating) ``SHARDED_STEPS`` steps unsharded, then on DTensors through
   ``make_train_step(rules=...)`` on a 1 x 1 NCCL ``DeviceMesh``
   (``ShardingRules``, every placement ``Replicate``): losses, parameters
   and moments bit for bit equal; 72 tensor-core attention launches a
   step (through ``local_map``) and no CUDA-core one; both runs' step
   ms, one sharded step profiled (idle share), the sharded run's peak
   memory; the group is destroyed after;
7b. memory estimate: ``launch/dryrun.py``'s tracker on exactly 7a's step
   (a fake 1 x 1 mesh, meta tensors, the abstract attention backend):
   its predicted peak beside 7a's measured one, within
   ``ESTIMATE_RATIO`` either way;
7c. production meshes: ``python -m repro_torch.launch.dryrun`` on the
   six ``DRYRUN_CELLS`` (qwen3-8b train_4k, prefill_32k and decode_32k on
   the single-pod (16, 16) mesh, command-r-plus-104b train_4k at all 64
   layers on the (2, 16, 16) mesh, qwen2-moe-a2.7b train_4k and
   mamba2-1.3b long_500k on the single pod), one subprocess a cell, all
   started together: each record's summary (flops/dev, collective MiB,
   mem/dev) and whether mem/dev fits one card's 80 GB; an error record
   fails the run;
8. summary: a ``kernels`` JSON line (each row with its launches in the
   serve run, a train step, the stream run, the tuned serve run, the
   mesh serve run, the analyze phase's probes, the paper networks'
   forwards and steps and the dense oracles phase's forwards;
   flash_attention's also in the minicpm-2b,
   command-r-plus-104b, qwen2-moe-a2.7b, llama4-scout-17b-a16e,
   recurrentgemma-2b and mamba2-1.3b runs, and in phases 6a-6e:
   ``qwen2_vl_serve_launches``, ``musicgen_launches``,
   ``lm_train_launches`` (8 steps), ``lm_train_f32_launches``,
   ``qwen2_vl_train_launches`` (3 steps), ``scanned_launches`` and
   ``sharded_train_launches`` (7a, 3 steps)),
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
import re
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
# rounding of the output and one of P (the tensor-core kernel's, for
# wgmma's bf16 A operand; the TPU kernel keeps P in float32) each add
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
# the paper networks (phase 4h): Table III's gcn, graphsage and
# graphsage_pool through repro_torch.core.models (hidden 16, one hidden
# layer: two layers in all), shard n 512, on full-scale Pubmed and on
# reddit with nodes and edges x REDDIT_SCALE: the dense (S, S, 512, 512)
# block grid of full-scale reddit (S 456) is ~218 GB a signature, beyond
# one card
PAPER_NETS = ("gcn", "graphsage", "graphsage_pool")
# reddit x0.1's rows sum ~500 (hub rows up to 19,353) weighted source rows
# in float32, in an order the plain backward's atomics (index_add_) leave
# to the card: a layer-0 pre-activation within that rounding of 0 takes
# the other side of relu than in another float32 sum, and a unit that
# flips moves its row's share of the gradient, ~1 / sqrt(13,888 train rows
# x 16 units) ~ 2e-3 of its norm. The card read 2.3e-4 between gcn's cuda
# and reference layer-0 gradients while layer 1's agree to 7e-7 (phase 4h
# prints both, and each backend against a float64 product; PERF.md §6).
# So on reddit the first layer's gradients are held to GRAD_REL_HUB
# (a few flips; a wrong kernel or index is off by O(1)); every other
# gradient to GRAD_REL.
GRAD_REL_HUB = 1e-2
PAPER_SHARD_N = 512
REDDIT_SCALE = 0.1
# kernel launches of one forward (tests/torch_launches.py states the
# same): gcn 2 fused layers; graphsage 2 shard_spmm + 2 dense (the concat
# product); graphsage_pool 4 dense (pool and concat per layer) + 2
# gathers. A train step launches its forward's kernels and no more.
PAPER_LAUNCHES = {
    "gcn": {"fused_gnn": 2},
    "graphsage": {"shard_spmm": 2, "dense_engine": 2},
    "graphsage_pool": {"dense_engine": 4, "seg_gather": 2},
}
# phase 4i: a cuda forward against the dense-adjacency oracles, atol =
# rtol, the reference's own tolerance for its zoo against them
# (tests/test_gnn_models.py); both sides float32 with TF32 off
ORACLE_TOL = 5e-5
ORACLE_SHARD_N = 512       # phase 4's shard n: S 39, 19,968 padded rows
# the five torch examples on the card (script, arguments), each within
# EXAMPLE_TIMEOUT_S seconds; serve_lm and train_lm at their defaults
EXAMPLE_RUNS = (
    ("torch_quickstart.py", ["--dataset", "pubmed"]),
    ("torch_serve_gnn.py", ["--dataset", "pubmed", "--scale", "1.0"]),
    ("torch_dataflow_explorer.py", ["--dataset", "pubmed"]),
    ("torch_serve_lm.py", []),
    ("torch_train_lm.py", []),
)
EXAMPLE_TIMEOUT_S = 300
# the two LMs after qwen3-8b: minicpm-2b at full width and depth, 4
# greedy requests of 1024 prompt tokens and 16 new tokens; its logits are
# rms_norm(x) . embed^T / 9 with embed drawn at std 0.02 over d 2304, so
# a logit's std is ~0.02 * 48 / 9 = 0.107, and a Gaussian's largest of
# 4 x 122,753 (~5 std) ~0.53, in [0.5, 1) where a bf16 ulp is 2^-8: the
# same 16 ulps as LM_LOGIT_ATOL give 0.0625 (0.25 would be ~2.3 std of
# the logits themselves). The card reads std 0.107 and a heavier tail,
# the largest 1.25, where 0.0625 is 8 ulps (PERF.md §6). The relative
# norm limit scales with the logits: 5e-2.
MINICPM_ARCH = "minicpm-2b"
MINICPM_LOGIT_ATOL = 0.0625
# command-r-plus-104b at full width (d 12288, 96/8 heads, dh 128, d_ff
# 33792, vocab 256,000, untied head) and 8 of its 64 layers: each layer is
# 1.57 B parameters (3.15 GB in bf16), the embedding and head 6.3 GB
# each, so 8 layers come to ~38 GB. One prefill batch of 2 x 1024 tokens,
# then 4 decode steps (5 new tokens). Its untied head is drawn at std
# d^-1/2, so its logits have unit std like qwen3-8b's: LM_LOGIT_ATOL.
COMMAND_R_ARCH = "command-r-plus-104b"
COMMAND_R_LAYERS = 8
# The MoE, hybrid and SSM models. qwen2-moe-a2.7b at full width and depth
# (14.32 B parameters, 28.6 GB): 4 requests of 1024 tokens, 16 new, one
# of them sampled at SAMPLE_TEMPERATURE. llama4-scout-17b-a16e at full
# width and LLAMA4_LAYERS of 48 layers (19.69 B parameters, 39.4 GB;
# 48 layers are 107.8 B, 216 GB): 2 requests of 1024 tokens, 5 new.
# recurrentgemma-2b (2.89 B) with prompts shorter than (1024) and equal to
# (2048) its 2048-token window, 16 new tokens, so that decode wraps the
# ring buffer; its local attention is MQA 10/1 at dh 256 on the
# tensor-core flash_attention. mamba2-1.3b (1.34 B): 4 x 1024, 16 new; no
# attention.
# Logit gates, set before the first run: each head gives logits of about
# unit std (untied heads drawn at std d^-1/2; tied embeddings at std 0.02,
# 0.02 * sqrt(2560) = 1.01 and 0.02 * sqrt(2048) = 0.91), as qwen3-8b's,
# so LM_LOGIT_ATOL and LM_LOGIT_REL. The two backends differ in attention
# only, and a bf16 difference there can move a near-tied top-k choice of
# a later layer's router, which changes that token's FFN output
# discretely: for the MoE models the gate holds the reference run with the
# cuda run's routing replayed (the continuous error), and the free-running
# run's routing agreement per layer and its error are printed beside it.
QWEN_MOE_ARCH = "qwen2-moe-a2.7b"
LLAMA4_ARCH = "llama4-scout-17b-a16e"
LLAMA4_LAYERS = 8
RG_ARCH = "recurrentgemma-2b"
MAMBA_ARCH = "mamba2-1.3b"
SAMPLE_TEMPERATURE = 0.8
# recurrentgemma's attention shape for phase 5: B 4, Hq 10, Hkv 1, dh 256
RG_ATTN = (4, 10, 1, 256)
RG_WINDOW = 2048
# One full-width layer against float64, relative norm. The RG-LRU's
# doubling scan (float32, log2 S levels of a·h + u with a < 1): a few
# float32 roundings a level, ~1e-6; 1e-5. The chunked SSD (float32):
# exp of differences of cumulative sums over a 256-step chunk, whose
# magnitude reaches ~100-400 (dt·A), carries ~400 * 6e-8 = 2.4e-5
# relative; 1e-4. The MoE dispatch and combine in float32 (TF32 off)
# against a per-token float64 loop with the same routing and drops: sums
# of 2048 and 1408 products, ~3e-6; 1e-5.
RGLRU_REL = 1e-5
SSD_REL = 1e-4
MOE_REL = 1e-5
# Phase 6a: qwen2-vl-2b at full width and depth (1.55 B parameters, 3.1 GB
# in bf16; GQA 12/2 at dh 128 on the tensor-core flash_attention): B
# VLM_BATCH prompts of frontend-embedding rows under Qwen2-VL's M-RoPE
# ids, VLM_GRID = 64 text positions, a 28 x 32 image grid, 64 text
# positions (1024 in all), then LM_NEW_TOKENS decode steps. Its head is
# untied and drawn at std d^-1/2, so its logits have unit std like
# qwen3-8b's: LM_LOGIT_ATOL and LM_LOGIT_REL.
VLM_ARCH = "qwen2-vl-2b"
VLM_BATCH = 4
VLM_GRID = (64, 28, 32, 64)
# Phase 6b: musicgen-large at full width and depth (2.45 B, 4.9 GB; MHA
# 32/32 at dh 64 on the tensor-core kernel), 4 requests of (1024, 4)
# codebook prompts, 16 new tokens, one of them at SAMPLE_TEMPERATURE. Its
# four untied heads are drawn at std d^-1/2: LM_LOGIT_ATOL and
# LM_LOGIT_REL over the (4, 4, 2048) logits.
MUSICGEN_ARCH = "musicgen-large"
# Phase 6c: qwen2.5-3b trained at full width and depth (3.09 B, tied
# embeddings) on one fixed batch of TRAIN_LM_BATCH tokens, lr
# TRAIN_LM_LR after one warm-up step; a preemption after TRAIN_CKPT_STEP
# steps, saved by the TrainLoop and resumed by a new one.
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_LM_BATCH = (4, 512)
TRAIN_LM_STEPS = 8
TRAIN_LM_LR = 1e-4
TRAIN_CKPT_STEP = 4
# Step-0 gradients through the kernels against the reference backend, per
# leaf, relative norm, in bf16. The backward is the same plain autograd
# on both sides; the forwards differ in attention, whose bf16 output may
# differ by one rounding (2^-9 relative) and whose P is rounded to bf16
# before P V in the kernel: a few 1e-3 relative in each layer's
# attention output, carried through 36 bf16 layers forward and back into
# every gradient, so a few 1e-2 at most; the card reads 3.9e-2 at
# qwen2.5-3b's worst leaf (a bk) and 4.3e-2 at qwen2-vl-2b's (a wq),
# while the float32 check below reads 3.8e-6 (PERF.md). A gradient that
# misses attention's share reads 1.0 at wq, wk and wv. The losses (~ln V
# = 11.9 at random init) agree within LM_LOSS_ATOL, ~1e-3 relative (the
# card: 1.4e-4 and 6.5e-5).
LM_GRAD_REL = 5e-2
LM_LOSS_ATOL = 1e-2
# the same gradients in float32 at TRAIN_F32_LAYERS of the 36 layers, on
# TRAIN_F32_BATCH tokens, through the CUDA-core kernel: the kernels'
# float32 rounding only, as the GNN train phase: GRAD_REL
TRAIN_F32_LAYERS = 2
TRAIN_F32_BATCH = (2, 512)
# Phase 6d: qwen2-vl-2b trained with int8 gradient compression and error
# feedback, VLM_TRAIN_STEPS steps on TRAIN_LM_BATCH embedding rows under
# the ids of VLM_TRAIN_GRID (64 text positions, then 14 rows of the 32-wide
# grid of 6a: 512 positions)
VLM_TRAIN_STEPS = 3
VLM_TRAIN_GRID = (64, 14, 32, 0)
# Phase 6e: recurrentgemma-2b's scanned forward (period 3: 8 stacked
# groups, 2 trailing layers) on SCAN_BATCH tokens. A group's slice of a
# stacked leaf is contiguous, so the same kernels see the same numbers and
# the logits should be equal; SCAN_ATOL (four bf16 ulps at |logit| ~1)
# bounds what another cuBLAS choice for a sliced operand could change.
SCAN_ARCH = RG_ARCH
SCAN_BATCH = (4, 1024)
SCAN_ATOL = 1e-3
# Phase 7a: phase 6c's model, seed and batch trained SHARDED_STEPS steps
# through make_train_step(rules=...) on a 1 x 1 NCCL DeviceMesh: every
# placement Replicate, so every local op is the unsharded step's and the
# results must be equal bit for bit.
SHARDED_STEPS = 3
# Phase 7b: the dry-run's memory tracker on 7a's step (a fake 1 x 1
# mesh, meta tensors) against the card's measured peak: within a factor
# of ESTIMATE_RATIO either way (eager live bytes; the caching allocator's
# blocks are not counted on either side).
ESTIMATE_RATIO = 2.0
# Phase 7c: the production-mesh dry-run on six cells, each a subprocess
# (all started together, DRYRUN_TIMEOUT_S each).
DRYRUN_CELLS = (("qwen3-8b", "train_4k", "single"),
                ("qwen3-8b", "prefill_32k", "single"),
                ("qwen3-8b", "decode_32k", "single"),
                ("command-r-plus-104b", "train_4k", "multi"),
                ("qwen2-moe-a2.7b", "train_4k", "single"),
                ("mamba2-1.3b", "long_500k", "single"))
DRYRUN_TIMEOUT_S = 400
H100_BYTES = 80e9


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
    runtime.default_store().evict()      # fit's full-graph build
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
    # the sage_max and gat compiles that raised built into the default store
    runtime.default_store().evict()
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
    runtime.default_store().evict()      # the gate's compiles and fit
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


def _requiring_grad(params: dict) -> tuple[dict, dict]:
    """A copy of a ``{"layers": [...]}`` tree whose leaves need
    gradients, and those leaves by name."""
    tree = {"layers": [{k: v.detach().clone().requires_grad_()
                        for k, v in layer.items()}
                       for layer in params["layers"]]}
    return tree, {f"layers/{i}/{k}": v
                  for i, layer in enumerate(tree["layers"])
                  for k, v in layer.items()}


def _paper_networks(card: str, label: str, ds, gts: dict,
                    launches: dict, first_layer_rel: float = GRAD_REL,
                    oracle: bool = False) -> dict:
    """gcn, graphsage and graphsage_pool (``core.models``) on one graph:
    logits within 1e-4 of the same ``make_forward`` on a controller
    pinned to ``reference``, launches per forward and per train step
    exactly ``PAPER_LAUNCHES``, the masked cross-entropy step's gradients
    finite, nonzero and within ``GRAD_REL`` of the reference backend's
    (the first layer's within ``first_layer_rel``); the median
    synchronized forward printed; with ``oracle``, the logits also held
    to the dense-adjacency oracles (``_oracle_check``). Adds the forwards'
    and steps' launches to ``launches``; returns gcn's gradients by
    backend."""
    from repro_torch.core import models
    from repro_torch.core.engines import (DenseEngine, GNNeratorController,
                                          GraphEngine)
    from repro_torch.kernels.registry import get_backend
    from repro_torch.runtime.fit import masked_cross_entropy

    ref_be = get_backend("reference")
    ref_ctrl = GNNeratorController(dense=DenseEngine(backend=ref_be),
                                   graph=GraphEngine(backend=ref_be))
    prof = ds.profile
    dev = gts[PAPER_NETS[0]].device
    feats = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).long().to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    gcn_grads = {}
    for net in PAPER_NETS:
        gt = gts[net]
        spec = models.paper_spec(net, prof.feature_dim, prof.num_classes)
        params = models.init_gnn(torch.Generator(dev).manual_seed(0), spec)
        h = gt.group(feats)
        fwds = {"cuda": models.make_forward(spec),
                "reference": models.make_forward(spec, ref_ctrl)}
        with torch.inference_mode():
            logits, fwd_launches = _launched(
                lambda: fwds["cuda"](params, gt, h))
            expect, ref_launches = _launched(
                lambda: fwds["reference"](params, gt, h))
        if fwd_launches != PAPER_LAUNCHES[net] or ref_launches:
            raise AssertionError(f"paper {label} {net}: a forward launched "
                                 f"{fwd_launches} (reference backend "
                                 f"{ref_launches}), expected "
                                 f"{PAPER_LAUNCHES[net]}")
        if logits.shape != (prof.num_nodes, prof.num_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"paper {label} {net}: logits "
                                 f"{tuple(logits.shape)} not finite or of "
                                 f"the wrong shape")
        err = (logits - expect).abs().max().item()
        torch.testing.assert_close(logits, expect, atol=1e-4, rtol=1e-4)
        if oracle:
            _oracle_check(f"paper {label} {net}", net, logits,
                          params["layers"], gt, feats, card)

        # the cuda step twice: the spread between two runs of the same
        # code is the plain backward's atomics at work
        losses, grads, step_launches = {}, {}, {}
        for name, fwd in (("cuda", fwds["cuda"]), ("cuda_again", fwds["cuda"]),
                          ("reference", fwds["reference"])):
            p, leaves = _requiring_grad(params)

            def step(fwd=fwd, p=p, leaves=leaves):
                loss = masked_cross_entropy(fwd(p, gt, h), labels, mask)
                return loss, dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))

            (losses[name], grads[name]), step_launches[name] = \
                _launched(step)
            del p, leaves
        if step_launches["cuda"] != PAPER_LAUNCHES[net] or \
                step_launches["cuda_again"] != PAPER_LAUNCHES[net] or \
                step_launches["reference"]:
            raise AssertionError(f"paper {label} {net}: a train step "
                                 f"launched {step_launches}")
        rels, spread = {}, {}
        for key, g in grads["cuda"].items():
            e = grads["reference"][key]
            if not torch.isfinite(g).all() or not g.abs().sum() > 0:
                raise AssertionError(f"paper {label} {net}: gradient of "
                                     f"{key} not finite or zero")
            scale = e.norm().clamp_min(1e-30)
            rels[key] = ((g - e).norm() / scale).item()
            spread[key] = float(
                f"{((g - grads['cuda_again'][key]).norm() / scale).item():.3e}")
        limits = {key: first_layer_rel if key.startswith("layers/0/")
                  else GRAD_REL for key in rels}
        worst = max(rels, key=rels.get)
        if any(rels[key] > limits[key] for key in rels):
            raise AssertionError(f"paper {label} {net}: gradients vs the "
                                 f"reference backend, relative norms {rels}"
                                 f" (limits {limits})")
        for got in (fwd_launches, step_launches["cuda"],
                    step_launches["cuda_again"]):
            for k, v in got.items():
                launches[k] += v
        with torch.inference_mode():
            fwd_ms = float(np.median([
                _synced(lambda: fwds["cuda"](params, gt, h))[1]
                for _ in range(5)]))
        print(f"paper {label} {net} ({card}): logits "
              f"{tuple(logits.shape)} vs reference backend max_abs_err "
              f"{err:.3e} (|logit| max {expect.abs().max().item():.3e}); "
              f"forward launches {fwd_launches}; step loss "
              f"{losses['cuda'].item():.6f} (reference "
              f"{losses['reference'].item():.6f}), gradient relative norms "
              f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} } (limit "
              f"{limits[worst]} at the largest, {worst}); between two cuda "
              f"steps {spread}; step "
              f"launches {step_launches['cuda']}; forward median "
              f"{fwd_ms:.3f} ms (of 5, host clock, synchronized)")
        if net == "gcn":
            gcn_grads = grads
        del logits, expect, grads, params, h, fwds
    return gcn_grads


def _gcn_float64_check(card: str, ds, gt, grads: dict) -> None:
    """gcn's step on ``gt`` in float64 (the kept index as a sparse CSR
    product, the same seeded parameters): each backend's gradients
    against it, and the pre-activations of layer 0 nearest 0 (a relu
    there may fall on either side in float32)."""
    from repro_torch.core import models

    prof, dev = ds.profile, gt.device
    spec = models.paper_spec("gcn", prof.feature_dim, prof.num_classes)
    params = models.init_gnn(torch.Generator(dev).manual_seed(0), spec)
    w0, w1 = (layer["w"].double().requires_grad_()
              for layer in params["layers"])
    idx, rows = gt.linear_index, gt.S * gt.n
    a = torch.sparse_csr_tensor(idx.row_ptr.long(), idx.col.long(),
                                idx.val.double(), size=(rows, rows))
    x = gt.group(torch.from_numpy(ds.features).to(dev)).reshape(rows, -1)
    pre0 = (a @ x.double()) @ w0
    logits = ((a @ torch.relu(pre0)) @ w1)[: prof.num_nodes]
    # masked_cross_entropy in float64 (the runtime's casts to float32)
    labels = torch.from_numpy(ds.labels).long().to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev).double()
    nll = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    loss = (nll * mask).sum() / mask.sum()
    truth = dict(zip(("layers/0/w", "layers/1/w"),
                     torch.autograd.grad(loss, [w0, w1])))

    def rel(g, t):
        return float(f"{((g.double() - t).norm() / t.norm()).item():.3e}")

    rels = {name: {k: rel(g[k], t) for k, t in truth.items()}
            for name, g in grads.items()}
    near = pre0.detach()[: prof.num_nodes].abs()
    print(f"paper gcn float64 check ({card}): gradient relative norms vs a "
          f"float64 product {rels}; layer-0 pre-activations of the "
          f"{prof.num_nodes} nodes: {int((near < 1e-9).sum())} within 1e-9 "
          f"of 0, {int((near < 1e-7).sum())} within 1e-7, smallest "
          f"{near.min().item():.3e} (std {pre0.std().item():.3e})")


def _paper_routing(dev, card: str, ds) -> None:
    """Per-op backend routing on full-scale Pubmed: ``op_backends=`` and
    ``REPRO_KERNEL_BACKEND_GATHER_AGGREGATE`` take sage_max's gathers off
    the kernel (0 seg_gather, 4 dense_engine launches, logits within 1e-4
    of the all-cuda compile); an explicit ``backend="cuda"`` beats the
    variable; gat with ``graph_aggregate_indexed`` on ``reference``
    launches no shard_spmm for its heads."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec

    prof = ds.profile
    kw = dict(device=dev, max_shard_n=PAPER_SHARD_N,
              store=runtime.GraphStore(), graph_key="pubmed")
    checks = []

    def routed(exe, label, expect, want):
        logits, got = _launched(exe.forward)
        if got != want:
            raise AssertionError(f"routing {label}: a forward launched "
                                 f"{got}, expected {want}")
        err = (logits - expect).abs().max().item()
        torch.testing.assert_close(logits, expect, atol=1e-4, rtol=1e-4)
        checks.append(f"{label}: {exe.backend_name}, launches {got}, vs "
                      f"all-cuda max_abs_err {err:.3e}")

    for arch, per_op, off in (
            ("sage_max", {"gather_aggregate": "reference"},
             {"dense_engine": 4}),
            ("gat", {"graph_aggregate_indexed": "reference"},
             {"dense_engine": 2})):
        spec = ZooSpec(arch, prof.feature_dim, 16, prof.num_classes)
        base = runtime.compile(spec, ds, **kw)
        expect, got = _launched(base.forward)
        if got != FORWARD_LAUNCHES[arch]:
            raise AssertionError(f"routing {arch}: the all-cuda forward "
                                 f"launched {got}")
        routed(runtime.compile(spec, ds, params=base.params,
                               op_backends=per_op, **kw),
               f"{arch} op_backends={per_op}", expect, off)
        if arch != "sage_max":
            continue
        var = "REPRO_KERNEL_BACKEND_GATHER_AGGREGATE"
        os.environ[var] = "reference"
        try:
            routed(runtime.compile(spec, ds, params=base.params, **kw),
                   f"{arch} {var}=reference", expect, off)
            routed(runtime.compile(spec, ds, params=base.params,
                                   backend="cuda", **kw),
                   f"{arch} backend='cuda' over {var}", expect,
                   FORWARD_LAUNCHES[arch])
        finally:
            os.environ.pop(var)
    print(f"paper routing ({card}, Pubmed): " + "; ".join(checks))


def _paper_default_store(dev, card: str, ds) -> None:
    """Two standalone gcn compiles on full-scale Pubmed share one build
    of ``default_store()`` (one graph build, the same ``gt``);
    ``default_store().evict()`` frees its blocks."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.runtime.cache import compile_counts

    store = runtime.default_store()
    if len(store):
        raise AssertionError(f"the default store holds {len(store)} "
                             f"builds from earlier phases")
    prof = ds.profile
    spec = ZooSpec("gcn", prof.feature_dim, 16, prof.num_classes)
    builds0 = compile_counts()["graph_builds"]
    e1, ms1 = _synced(lambda: runtime.compile(spec, ds, device=dev,
                                              max_shard_n=PAPER_SHARD_N))
    e2, ms2 = _synced(lambda: runtime.compile(spec, ds, device=dev,
                                              max_shard_n=PAPER_SHARD_N,
                                              seed=1))
    builds = compile_counts()["graph_builds"] - builds0
    if e1.gt is not e2.gt or builds != 1:
        raise AssertionError(f"default store: {builds} graph builds for two "
                             f"compiles, gt shared {e1.gt is e2.gt}")
    if not torch.isfinite(e2.forward()).all():
        raise AssertionError("default store: non-finite logits")
    blocks = e1.gt.blocks.numel() * e1.gt.blocks.element_size()
    del e1, e2
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    store.evict()
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    if freed < blocks or len(store):
        raise AssertionError(f"default_store().evict() freed {freed} bytes, "
                             f"the blocks alone are {blocks}")
    print(f"paper default_store ({card}, Pubmed gcn): two standalone "
          f"compiles share gt, 1 graph build (compiles {ms1:.1f} ms then "
          f"{ms2:.1f} ms, host clock, synchronized); evict() freed "
          f"{freed / 1e9:.3f} GB (blocks {blocks / 1e9:.3f} GB)")


def _reddit_kernel_rows(kernels: dict, ds, gts: dict) -> None:
    """The four GNN kernels against their plain versions at reddit's
    layer-0 shapes (D 602), timed beside their bound and a library call
    as phase 3 times them at Pubmed's; a ``reddit`` entry on each row."""
    from repro_torch.kernels import dense_engine, fused_gnn, ref, seg_gather
    from repro_torch.kernels import shard_spmm

    dev = gts["gcn"].device
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    h = gts["gcn"].group(torch.from_numpy(ds.features).to(dev))
    s, n, d = h.shape
    rows = s * n
    peak = "3.35 TB/s; f32 67 TFLOP/s (CUDA cores)"

    def report(name, row):
        kernels[name]["reddit"] = row
        print(f"kernel {name} reddit x{REDDIT_SCALE:g}: max_abs_err "
              f"{row['max_abs_err']:.3e} | kernel_ms {row['ms']:.3f} "
              f"plain_ms {row['plain_ms']:.3f} library_ms "
              f"{row['library_ms']:.3f} bound_ms {row['bound_ms']:.3f} "
              f"({row['bound_by']}) | "
              + ", ".join(f"{k} {v}" for k, v in row.items()
                          if k not in ("max_abs_err", "ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "bound_by")))

    # shard_spmm: graphsage's mean blocks over the kept index
    mgt = gts["graphsage"]
    blocks, idx = mgt.blocks, mgt.linear_index
    nnz = idx.col.numel()
    out = shard_spmm.shard_spmm(blocks, h, index=idx)
    plain = ref.shard_spmm(blocks, h)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    sparse = torch.sparse_csr_tensor(idx.row_ptr, idx.col, idx.val,
                                     size=(rows, rows))
    report("shard_spmm", {
        **_measure(out, plain,
                   lambda: shard_spmm.shard_spmm(blocks, h, index=idx),
                   lambda: ref.shard_spmm(blocks, h),
                   lambda: (sparse @ h.reshape(rows, -1)).reshape(s, n, d),
                   _nbytes(idx.row_ptr, idx.col, idx.val, h, out),
                   2.0 * nnz * d),
        "nnz": nnz, "hub_rows": idx.hubs.numel(), "bound_peak": peak,
        "library": "cuSPARSE CSR x h over the kept index",
        "shape": {"s": s, "n": n, "d": d}})
    del out, plain, sparse

    # fused_gnn: gcn's normalized blocks, D 602 -> F 16, relu
    ggt = gts["gcn"]
    gblocks, lindex = ggt.blocks, ggt.linear_index
    gnnz = lindex.col.numel()
    w = randn(d, 16, scale=(2.0 / (d + 16)) ** 0.5)
    out = fused_gnn.fused_gnn_layer(gblocks, h, w, activation="relu",
                                    index=lindex)
    plain = ref.fused_gnn(gblocks, h, w, activation="relu")
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    csr = torch.sparse_csr_tensor(lindex.row_ptr, lindex.col, lindex.val,
                                  size=(rows, rows))
    report("fused_gnn", {
        **_measure(out, plain,
                   lambda: fused_gnn.fused_gnn_layer(gblocks, h, w,
                                                     activation="relu",
                                                     index=lindex),
                   lambda: ref.fused_gnn(gblocks, h, w, activation="relu"),
                   lambda: torch.relu((csr @ h.reshape(rows, -1)) @ w)
                   .reshape(s, n, -1),
                   _nbytes(lindex.row_ptr, lindex.col, lindex.val, h, w,
                           out),
                   2.0 * gnnz * d + 2.0 * rows * d * 16),
        "nnz": gnnz, "hub_rows": lindex.hubs.numel(), "bound_peak": peak,
        "library": "cuSPARSE CSR x h over the kept index, @ w, relu",
        "shape": {"s": s, "n": n, "d": d, "f": 16}})
    del out, plain, csr

    # dense_engine: graphsage_pool's layer-0 pool product (no bias), also
    # held to the float64 product
    x = h.reshape(rows, d)
    wp = randn(d, d, scale=(1.0 / d) ** 0.5)
    out = dense_engine.dense_engine_matmul(x, wp, activation="relu")
    plain = ref.dense_engine(x, wp, activation="relu")
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    exact = x.double() @ wp.double()
    got = dense_engine.dense_engine_matmul(x, wp)
    rel64 = ((got.double() - exact).norm() / exact.norm()).item()
    if rel64 > DENSE_REL:
        raise AssertionError(f"dense_engine reddit: relative norm "
                             f"{rel64:.3e} vs float64 above {DENSE_REL}")
    del exact, got
    report("dense_engine", {
        **_measure(out, plain,
                   lambda: dense_engine.dense_engine_matmul(
                       x, wp, activation="relu"),
                   lambda: ref.dense_engine(x, wp, activation="relu"),
                   lambda: torch.relu(torch.mm(x, wp)),
                   _nbytes(x, wp, out), 3 * 2.0 * rows * d * d,
                   PEAK_TF32_FLOPS),
        "rel_err_f64": rel64, "rel_tol": DENSE_REL,
        "bound_peak": "3 TF32 passes at 495 TFLOP/s dense tensor cores, "
                      "3.35 TB/s",
        "library": "torch.mm + relu", "shape": [rows, d, d]})

    # seg_gather: graphsage_pool's edge lists over its gather index, max
    # over the pool product; exact
    pgt = gts["graphsage_pool"]
    z = out.reshape(s, n, d)
    edges = (pgt.edge_src, pgt.edge_dst, pgt.edge_valid)
    index = pgt.gather_index
    out = seg_gather.seg_gather_aggregate(*edges, z, op="max", index=index)
    plain = ref.seg_gather(*edges, z, op="max")
    if not torch.equal(out, plain):
        raise AssertionError(f"seg_gather reddit: max abs err "
                             f"{(out - plain).abs().max().item():.3e}")
    ii, jj, ee = pgt.edge_valid.nonzero(as_tuple=True)
    dst = (ii * n + pgt.edge_dst[ii, jj, ee].long())[:, None].expand(-1, d)
    src = jj * n + pgt.edge_src[ii, jj, ee].long()
    del ii, jj, ee

    def library():
        # the kept-index library path (phase 3's): gather of the source
        # rows, one scatter_reduce, empty -> 0
        acc = torch.full((rows, d), float("-inf"), device=dev)
        acc.scatter_reduce_(0, dst, z.reshape(-1, d).index_select(0, src),
                            reduce="amax", include_self=True)
        return torch.where(torch.isfinite(acc), acc, 0.0)

    if not torch.equal(library().reshape(s, n, d), plain):
        raise AssertionError("seg_gather reddit: the library path differs "
                             "from the plain version")
    valid = src.numel()
    report("seg_gather", {
        **_measure(out, plain,
                   lambda: seg_gather.seg_gather_aggregate(
                       *edges, z, op="max", index=index),
                   lambda: ref.seg_gather(*edges, z, op="max"), library,
                   _nbytes(*edges, z, out), float(valid * d)),
        "valid_edges": valid, "edge_slots": int(pgt.edge_valid.numel()),
        "bound_peak": peak,
        "library": "gather + scatter_reduce over the kept index",
        "shape": {"s": s, "n": n, "d": d}})


def paper_phase(dev, card: str, kernels: dict) -> dict:
    """Phase 4h (see the module docstring): the paper networks on Pubmed
    and reddit, per-op routing, the default store, reddit's kernel rows.
    Returns the kernel launches of the networks' forwards and steps."""
    from repro_torch.core import models
    from repro_torch.core.engines import GraphTensors
    from repro_torch.core.sharding import shard_graph
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import _lib, csr

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(_lib.KERNELS, 0)

    pubmed = make_dataset("pubmed", seed=0)
    prof = pubmed.profile
    gts, build_s = _synced(lambda: {
        net: models.build_graph_tensors(pubmed.edges, prof.num_nodes,
                                        PAPER_SHARD_N, net, device=dev)
        for net in PAPER_NETS})
    print(f"paper pubmed ({card}): {prof.num_nodes} nodes, "
          f"{pubmed.edges.shape[0]} edges; three builds "
          f"{build_s / 1e3:.1f} s")
    _paper_networks(card, "pubmed", pubmed, gts, launches)
    del gts
    gc.collect()
    torch.cuda.empty_cache()
    _paper_routing(dev, card, pubmed)
    _paper_default_store(dev, card, pubmed)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reddit = make_dataset("reddit", seed=0, scale=REDDIT_SCALE)
    gen_s = time.perf_counter() - t0
    prof = reddit.profile
    gts, shard_s, upload_s = {}, {}, {}
    for net in PAPER_NETS:
        t0 = time.perf_counter()
        sg = shard_graph(reddit.edges, prof.num_nodes, PAPER_SHARD_N,
                         normalize=models.NORMALIZE[net],
                         add_self_loops=True)
        shard_s[net] = time.perf_counter() - t0
        gts[net], upload_ms = _synced(
            lambda: GraphTensors.from_sharded(sg, dev))
        upload_s[net] = upload_ms / 1e3
        del sg
    gt = gts["gcn"]
    deg = np.bincount(reddit.edges[:, 1], minlength=prof.num_nodes)
    print(f"paper reddit x{REDDIT_SCALE:g} ({card}): {prof.num_nodes} nodes, "
          f"{reddit.edges.shape[0]} directed edges + {prof.num_nodes} self "
          f"loops, {prof.feature_dim} features, {prof.num_classes} classes; "
          f"in-degree mean {deg.mean():.1f} max {deg.max()}; S {gt.S} of n "
          f"{gt.n}, {gt.blocks.numel() * 4 / 1e9:.2f} GB of blocks a "
          f"signature, edge slots a pair {gt.edge_src.shape[-1]}; host "
          f"build (host clock): generator {gen_s:.1f} s, shard_graph "
          + ", ".join(f"{k} {v:.1f} s" for k, v in shard_s.items())
          + ", upload " + ", ".join(f"{k} {v:.2f} s"
                                     for k, v in upload_s.items()))
    grads = _paper_networks(card, f"reddit x{REDDIT_SCALE:g}", reddit, gts,
                            launches, first_layer_rel=GRAD_REL_HUB,
                            oracle=True)
    _gcn_float64_check(card, reddit, gts["gcn"], grads)
    del grads
    print(f"paper reddit x{REDDIT_SCALE:g}: linear index hub rows (more "
          f"than {csr.HUB_ENTRIES} entries) "
          f"{gt.linear_index.hubs.numel()} of {gt.S * gt.n} rows")
    _reddit_kernel_rows(kernels, reddit, gts)
    del gts, gt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"paper phase wall time ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def _oracle_logits(arch: str, layers: list, gt,
                   feats: torch.Tensor) -> torch.Tensor:
    """(N, C) logits of ``kernels/ref.py``'s dense-adjacency oracles, layer
    by layer on ``gt``'s blocks flattened to one (S·n, S·n) adjacency, as
    the reference's tests/test_gnn_models.py runs its own. ``arch`` is a
    zoo arch or a paper network; ``feats`` (N, F) on the card."""
    from repro_torch.kernels import ref

    s, _, n, _ = gt.blocks.shape
    a = gt.blocks.permute(0, 2, 1, 3).reshape(s * n, s * n)
    h = torch.zeros((s * n, feats.shape[1]), device=feats.device)
    h[:feats.shape[0]] = feats
    for i, L in enumerate(layers):
        act = "relu" if i < len(layers) - 1 else "none"
        if arch == "gcn":
            h = ref.gcn_layer(a, h, L["w"], activation=act)
        elif arch in ("sage_mean", "graphsage"):
            h = ref.sage_mean_layer(a, h, L["w"], activation=act)
        elif arch in ("sage_max", "graphsage_pool"):
            h = ref.sage_max_pool_layer(a, h, L["w_pool"], L.get("b_pool"),
                                        L["w"], activation=act)
        elif arch == "gin":
            h = ref.gin_layer(a, h, L["eps"], L["w1"], L["b1"], L["w2"],
                              L["b2"], activation=act)
        else:
            h = ref.gat_layer(a, h, L["w"], L["a_src"], L["a_dst"],
                              activation=act)
    return h[:gt.num_nodes]


def _oracle_check(label: str, arch: str, logits: torch.Tensor, layers: list,
                  gt, feats: torch.Tensor, card: str) -> None:
    """Hold a cuda forward's ``logits`` to the dense-adjacency oracles on
    the same graph and parameters: atol = rtol = ``ORACLE_TOL``; the
    oracles must launch no kernel."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        expect, launched = _launched(
            lambda: _oracle_logits(arch, layers, gt, feats))
    oracle_s = time.perf_counter() - t0
    if launched:
        raise AssertionError(f"oracle {label}: the oracles launched "
                             f"{launched}")
    if expect.shape != logits.shape or not torch.isfinite(expect).all():
        raise AssertionError(f"oracle {label}: oracle logits "
                             f"{tuple(expect.shape)} not finite or not of "
                             f"the forward's shape {tuple(logits.shape)}")
    diff = logits - expect
    print(f"oracle {label} ({card}): logits {tuple(logits.shape)} vs the "
          f"dense-adjacency oracles max_abs_err "
          f"{diff.abs().max().item():.3e}, relative norm "
          f"{(diff.norm() / expect.norm().clamp_min(1e-30)).item():.3e} "
          f"(|logit| max {expect.abs().max().item():.3e}; gate atol = rtol "
          f"= {ORACLE_TOL:g}); oracles {oracle_s:.2f} s (host clock)")
    torch.testing.assert_close(logits, expect, atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)


def _explorer_host_report(args: list) -> list[str]:
    """The dataflow explorer's report computed in this process with
    ``--device cpu``: the numbers are host arithmetic, so the card's run
    must print the same lines (its Executable header names its device)."""
    import contextlib
    import importlib.util
    import io

    from repro_torch import runtime

    spec = importlib.util.spec_from_file_location(
        "torch_dataflow_explorer", ROOT / "examples" /
        "torch_dataflow_explorer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mod.main([*args, "--device", "cpu"]) != 0:
            raise AssertionError("dataflow explorer on the host failed")
    runtime.default_store().evict()
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("Executable[")]


def _example_verdict(script: str, out: str, host_explorer: list) -> str:
    """What one example's report must show (see the module docstring);
    returns its line for the log."""
    if script == "torch_quickstart.py":
        acc = re.search(r"train-acc ([\d.]+) test-acc ([\d.]+)", out)
        if not acc:
            raise AssertionError(f"{script}: no accuracy printed")
        return f"train-acc {acc[1]} test-acc {acc[2]}"
    if script == "torch_serve_gnn.py":
        done = re.search(r"server: (\d+)/(\d+) completed, 0 rejected, "
                         r"0 expired", out)
        if not done or done[1] != done[2]:
            raise AssertionError(f"{script}: not every request completed")
        return f"{done[1]}/{done[2]} requests completed"
    if script == "torch_dataflow_explorer.py":
        got = [ln for ln in out.splitlines()
               if not ln.startswith("Executable[")]
        if got != host_explorer:
            raise AssertionError(f"{script}: the card's report differs "
                                 f"from the host's:\n{out}")
        return (f"{len(got)} report lines equal the host's; "
                + next(ln for ln in got if "traffic ratio" in ln))
    if script == "torch_serve_lm.py":
        served = re.search(r"served (\d+) requests, (\d+) tokens", out)
        # the example's default: 24 new tokens a request
        if not served or int(served[2]) != int(served[1]) * 24:
            raise AssertionError(f"{script}: not every token served")
        return served[0]
    loss = re.search(r"loss: ([\d.]+) -> ([\d.]+) \(uniform floor "
                     r"([\d.]+)\)", out)
    if not loss or not float(loss[2]) < min(float(loss[1]), float(loss[3])):
        raise AssertionError(f"{script}: the final loss is not below the "
                             f"first and the uniform log V")
    return loss[0]


def example_runs(card: str, device: str = "cuda") -> None:
    """``EXAMPLE_RUNS`` as subprocesses on ``device``, all started
    together, each within ``EXAMPLE_TIMEOUT_S``; every one must exit 0
    and show what ``_example_verdict`` asks. The dataflow explorer's host
    report is computed here meanwhile. A fresh TMPDIR holds train_lm's
    default checkpoint directory and the outputs."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)
        t0 = time.perf_counter()
        procs, files = {}, {}
        try:
            for script, args in EXAMPLE_RUNS:
                files[script] = (open(os.path.join(tmp, script + ".out"),
                                      "w+"),
                                 open(os.path.join(tmp, script + ".err"),
                                      "w+"))
                procs[script] = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / script), *args,
                     "--device", device], stdout=files[script][0],
                    stderr=files[script][1], env=env, cwd=ROOT)
            host_explorer = _explorer_host_report(
                dict(EXAMPLE_RUNS)["torch_dataflow_explorer.py"])
            took = {}
            while len(took) < len(procs):
                for script, proc in procs.items():
                    if script not in took and proc.poll() is not None:
                        took[script] = time.perf_counter() - t0
                if time.perf_counter() - t0 > EXAMPLE_TIMEOUT_S:
                    raise AssertionError(
                        f"examples still running after {EXAMPLE_TIMEOUT_S} "
                        f"s: {sorted(set(procs) - set(took))}")
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for fh in files.values():
                for f in fh:
                    f.flush()
        for script, proc in procs.items():
            out_f, err_f = files[script]
            out_f.seek(0)
            err_f.seek(0)
            out, err = out_f.read(), err_f.read()
            out_f.close()
            err_f.close()
            if proc.returncode != 0:
                raise AssertionError(f"{script} exited {proc.returncode}:\n"
                                     f"{out[-3000:]}\n{err[-3000:]}")
            args = " ".join(dict(EXAMPLE_RUNS)[script]) or "(defaults)"
            print(f"example {script} {args} ({card}): exit 0 in {took[script]:.1f} s (all started "
                  f"together); {_example_verdict(script, out, host_explorer)}")


def oracle_phase(dev, card: str, device: str = "cuda") -> dict:
    """Phase 4i (see the module docstring): the five archs' cuda forwards
    on full-scale Pubmed against the dense-adjacency oracles, then the
    torch examples on ``device``. Returns the forwards' kernel
    launches."""
    from repro_torch import env, runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import _lib

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(_lib.KERNELS, 0)
    ds = make_dataset("pubmed", seed=0)
    prof = ds.profile
    feats = torch.from_numpy(ds.features).to(dev)
    store = runtime.GraphStore()
    with env.pinned():
        for arch in ARCHS:
            spec = ZooSpec(arch, prof.feature_dim, 16, prof.num_classes,
                           num_layers=2, heads=2)
            exe = runtime.compile(spec, ds, device=dev, backend="cuda",
                                  max_shard_n=ORACLE_SHARD_N, store=store)
            logits, fwd = _launched(exe.forward)
            if fwd != FORWARD_LAUNCHES[arch]:
                raise AssertionError(f"oracle pubmed {arch}: a forward "
                                     f"launched {fwd}, expected "
                                     f"{FORWARD_LAUNCHES[arch]}")
            for k, v in fwd.items():
                launches[k] += v
            _oracle_check(f"pubmed {arch}", arch, logits,
                          exe.params["layers"], exe.gt, feats, card)
            del exe, logits
    del store, feats
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    example_runs(card, device)
    print(f"oracle phase wall time ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{peak / 1e9:.2f} GB (this process; each example's is its own); "
          f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


def _attention_pairs(sq: int, skv: int, window: int | None = None) -> int:
    """(q, k) pairs a causal mask keeps: row i sees keys 0 .. Skv - Sq + i,
    and with a window only the last ``window`` of them."""
    seen = np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv)
    if window is not None:
        seen = np.minimum(seen, window)
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
            .abs().max().item(),
            p_rounding=_p_rounding(f"dh 128 GQA at {b}x{s}", out, plain, q,
                                   k, v))
    del q, k, v, out, plain, library

    # minicpm-2b's prefill shape: MHA (36/36 heads) at dh 64
    b64, h64, dh64 = 4, 36, 64
    if _route(torch.bfloat16, dh64) != "flash_attention_tc":
        raise AssertionError("bf16 at dh 64 is not routed to the "
                             "tensor-core kernel")
    mha = {}
    for plen in LM_PROMPTS:
        q, k, v = (torch.randn((b64, h64, plen, dh64), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out = flash_attention(q, k, v, causal=True)
        plain = ref.flash_attention(q, k, v, causal=True)
        err, rel = _attention_check(
            f"flash_attention bfloat16 (flash_attention_tc) MHA dh 64 q "
            f"{tuple(q.shape)} kv {tuple(k.shape)}", out, plain,
            torch.bfloat16)
        mha[plen] = {
            **_measure(out, plain,
                       lambda: flash_attention(q, k, v, causal=True),
                       lambda: ref.flash_attention(q, k, v, causal=True),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True),
                       _nbytes(q, k, v, out),
                       4.0 * dh64 * _attention_pairs(plen, plen) * b64 * h64,
                       PEAK_BF16_FLOPS),
            "rel_err": rel}
        print(f"flash_attention MHA dh 64 at {b64}x{plen}: "
              + ", ".join(f"{key} {val:.4g}" for key, val
                          in mha[plen].items() if key != "bound_by"))
        del q, k, v, out, plain
    results["flash_attention"]["dh64_mha"] = {
        "shape": {"b": b64, "hq": h64, "hkv": h64, "dh": dh64,
                  "dtype": "bfloat16", "causal": True},
        "library": "scaled_dot_product_attention", "by_prompt": mha}
    results["flash_attention"]["dh256_mqa_window"] = _attention_dh256(dev,
                                                                      gen)


def _p_rounding(label: str, out, plain, q, k, v, *,
                window: int | None = None) -> dict:
    """The kernel's relative-norm error against the plain version (float32
    P, as the Pallas kernel) and against the same computation rounding P
    to bf16 before P V (what wgmma's bf16 A operand makes the tensor-core
    kernel do; the denominator sums the float32 P). Causal, every row
    with a key. Printed; the gate is ``ATTN_REL`` against the first."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * dh ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    logits.masked_fill_(~keep, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    del logits
    rounded = (torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(),
                            v.float())
               / p.sum(-1, keepdim=True).clamp_min(1e-30))
    rounded = rounded.reshape(b, hq, sq, dh).to(q.dtype)
    del p

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm()).item()

    row = {"rel_vs_f32_p": rel(out, plain), "rel_vs_bf16_p": rel(out, rounded),
           "f32_p_vs_bf16_p": rel(plain, rounded)}
    print(f"P rounding, {label}: kernel vs float32-P plain (the gate) "
          f"{row['rel_vs_f32_p']:.3e}, vs bf16-P plain "
          f"{row['rel_vs_bf16_p']:.3e}; the two plain versions "
          f"{row['f32_p_vs_bf16_p']:.3e} apart (relative norm)")
    return row


def _attention_dh256(dev, gen) -> dict:
    """recurrentgemma-2b's local attention (MQA 10/1, dh 256, window 2048)
    on the tensor-core kernel, its bf16 route: against the plain version
    at S 1024, 2048, 4096 (where the window is narrower than the causal
    triangle) and Sq 512 < Skv 2048; the CUDA-core kernel forced through
    ``_launch`` on the same bf16 inputs, and on them in float32 (its
    route). At each length with Sq == Skv both kernels are timed beside
    the plain version, SDPA with the banded mask, SDPA with ``is_causal``
    (where S <= window, so the band is the causal mask) and the bound
    (bf16 tensor-core peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_launch, _route,
                                                     flash_attention)

    b, hq, hkv, dh = RG_ATTN
    w = RG_WINDOW
    if _route(torch.bfloat16, dh) != "flash_attention_tc":
        raise AssertionError("bf16 at dh 256 is not routed to the "
                             "tensor-core kernel")
    rows, p_rounding = {}, None
    for sq, skv in ((1024, 1024), (2048, 2048), (4096, 4096), (512, 2048)):
        q = torch.randn((b, hq, sq, dh), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, hkv, skv, dh), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        qpos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=dev)[None, :]
        band = (kpos <= qpos) & (kpos > qpos - w)

        def kernel(q=q, k=k, v=v):
            return flash_attention(q, k, v, causal=True, window=w)

        def cuda_core(q=q, k=k, v=v):
            return _launch("flash_attention", q, k, v, causal=True, window=w)

        def plain(q=q, k=k, v=v):
            return ref.flash_attention(q, k, v, causal=True, window=w)

        label = (f"flash_attention {{}} MQA dh 256 window {w} q "
                 f"{tuple(q.shape)} kv {tuple(k.shape)}")
        out, exp = kernel(), plain()
        err, rel = _attention_check(
            label.format("bfloat16 (flash_attention_tc)"), out, exp,
            torch.bfloat16)
        err_cc, rel_cc = _attention_check(
            label.format("bfloat16 (flash_attention, forced)"), cuda_core(),
            exp, torch.bfloat16)
        f32 = tuple(t.float() for t in (q, k, v))
        err32, rel32 = _attention_check(
            label.format("float32 (flash_attention)"), kernel(*f32),
            plain(*f32), torch.float32)
        row = {"max_abs_err": err, "rel_err": rel,
               "cuda_core_max_abs_err": err_cc, "cuda_core_rel_err": rel_cc,
               "f32_max_abs_err": err32, "f32_rel_err": rel32}
        if sq == skv:
            row.update(_measure(
                out, exp, kernel, plain,
                lambda q=q, k=k, v=v, band=band:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                   enable_gqa=True),
                _nbytes(q, k, v, out),
                4.0 * dh * _attention_pairs(sq, skv, w) * b * hq,
                PEAK_BF16_FLOPS))
            row["cuda_core_ms"] = _ms(cuda_core)
            row["sdpa_causal_ms"] = _ms(
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)) \
                if sq <= w else None
            row["f32_ms"] = _ms(lambda f32=f32: kernel(*f32))
            print(f"flash_attention MQA dh 256 window {w} at {b}x{sq}: "
                  + ", ".join(f"{key} {val:.4g}" for key, val in row.items()
                              if val is not None and key != "bound_by"))
        if (sq, skv) == (2048, 2048):
            p_rounding = _p_rounding(f"dh 256 MQA window {w} at {b}x{sq}",
                                     out, exp, q, k, v, window=w)
        rows[f"{sq}x{skv}"] = row
        del q, k, v, out, exp, f32, band
    return {"shape": {"b": b, "hq": hq, "hkv": hkv, "dh": dh,
                      "dtype": "bfloat16", "causal": True, "window": w},
            "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
            "launch_counter": "flash_attention_tc",
            "cuda_core_source": "src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
            "library": "scaled_dot_product_attention, banded boolean mask "
                       "(sdpa_causal_ms: is_causal, where S <= window)",
            "bound_peak": "989 TFLOP/s dense bf16 tensor cores, 3.35 TB/s",
            "p_rounding": p_rounding, "by_shape": rows}


def _leaves(tree) -> list:
    """The tensors of a parameter tree (dicts and lists, any depth)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _expected_attention_launches(cfg, batches: int) -> dict:
    """flash_attention launches of ``batches`` prefill batches: one per
    attention layer (attn or local_attn) per batch, on the kernel that
    ``_route`` picks for the compute dtype and head dim."""
    from repro_torch.kernels.flash_attention import _route

    expect = {"flash_attention_tc": 0, "flash_attention": 0}
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.pattern)
    if n_attn:
        expect[_route(cfg.cdtype, cfg.head_dim)] = n_attn * batches
    return expect


def _logits_close(label: str, got, want, atol: float) -> None:
    """Hold logits to ``want`` within ``atol`` (max abs) and
    ``LM_LOGIT_REL`` (relative norm); print both."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"{label}: max_abs_err {err:.4e} (tol {atol}), rel norm "
          f"{rel:.4e} (tol {LM_LOGIT_REL}), |logit| max "
          f"{want.abs().max().item():.3f}")
    if not (err <= atol and rel <= LM_LOGIT_REL):
        raise AssertionError(f"{label}: logits disagree")


def _check_launches(label: str, cfg, launches: dict, per_layer: int) -> None:
    """The flash_attention launches must be ``per_layer`` per attention
    layer on the kernel ``_route`` picks, and none on the other."""
    expect = _expected_attention_launches(cfg, per_layer)
    got = {k: launches[k] for k in expect}
    if got != expect:
        raise AssertionError(f"{label}: flash_attention launches {got}, "
                             f"expected {expect}")


def _setup(cfg, params, t0: float, label: str) -> None:
    """Check the parameter count and print the model's size."""
    from repro_torch.models import lm

    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    if n_params != cfg.num_params() + lm.uncounted_params(cfg):
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.num_params()} + "
                             f"{lm.uncounted_params(cfg)}")
    print(f"{label} setup: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} dh {cfg.head_dim} "
          f"{n_params / 1e9:.3f} B params, {_nbytes(*leaves) / 1e9:.2f} GB "
          f"{cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")


def _phase_end(label: str, card: str, t_phase: float) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} wall time ({card}): {time.perf_counter() - t_phase:.1f} "
          f"s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def lm_serve_phase(card: str, arch: str = LM_ARCH,
                   prompts: tuple[int, ...] = LM_PROMPTS,
                   per_prompt: int = LM_REQUESTS_PER_PROMPT,
                   new_tokens: int = LM_NEW_TOKENS, *,
                   n_layers: int | None = None,
                   logit_atol: float = LM_LOGIT_ATOL,
                   profile: bool = True, sampled: bool = False,
                   checks: bool = False, device: str = "cuda") -> int:
    """Serve ``arch`` at full width through the Server (``n_layers`` cuts
    its depth), ``per_prompt`` greedy requests per prompt length (with
    ``sampled`` the last request of the first length at
    ``SAMPLE_TEMPERATURE``, whose batch must then repeat bitwise from the
    same engine seed); ``checks`` adds the float64 layer checks and the
    prefill + decode vs forward check (:func:`lm_layer_checks`). Returns
    the flash_attention launches (both kernels) of the served run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import (build_lm_engine, drive_lm,
                                          latency_percentiles, lm_report,
                                          lm_requests, parser)
    from repro_torch.models import lm
    from repro_torch.serving import Completed, ServeEngine

    args = parser().parse_args(
        ["--mode", "lm", "--arch", arch, "--no-smoke", "--device", device,
         "--prompt-len", str(max(prompts)),
         "--new-tokens", str(new_tokens), "--batch-size", "4"])
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if n_layers is None:
        engine = build_lm_engine(args)
    else:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers)
        print(f"lm {arch}: depth cut to {n_layers} of {full.n_layers} "
              f"layers ({cfg.num_params() / 1e9:.2f} B of "
              f"{full.num_params() / 1e9:.2f} B parameters), full width")
        engine = ServeEngine(
            cfg, lm.init_params(cfg, torch.Generator(device).manual_seed(0)),
            max_len=args.prompt_len + args.new_tokens + 1, device=device,
            backend=args.backend)
    torch.cuda.synchronize()
    cfg = engine.cfg
    _setup(cfg, engine.params, t0, "lm")
    print(f"lm max_len {engine.max_len}")

    requests = [r for i, plen in enumerate(prompts)
                for r in lm_requests(cfg, per_prompt, plen, new_tokens,
                                     seed=1 + i)]
    if sampled:
        requests[per_prompt - 1].temperature = SAMPLE_TEMPERATURE
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
    want = (new_tokens,) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                            else ())
    for o in done:
        toks = o.value
        if toks.shape != want or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"bad generated tokens {toks}")
    batches = engine.stats["prefill_batches"]
    expect = _expected_attention_launches(cfg, batches)
    got = {k: launches[k] for k in expect}
    p50, p95, p99 = latency_percentiles(outcomes)
    print(server.report())
    print(f"lm serve {arch} ({card}): {len(done)}/{len(requests)} requests, "
          f"{sum(len(o.value) for o in done)} tokens in {wall:.3f} s | "
          f"{lm_report(engine)} | latency p50 {p50:.3f} ms, p95 {p95:.3f} "
          f"ms, p99 {p99:.3f} ms | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"lm serve {arch}: kernel launches {launches}")
    if batches != len(prompts) or got != expect:
        raise AssertionError(
            f"flash_attention launches {got} over {batches} prefill "
            f"batches; expected {expect} over {len(prompts)} batches")
    if engine.stats["decode_steps"] != batches * (new_tokens - 1):
        raise AssertionError(f"{engine.stats['decode_steps']} decode steps, "
                             f"expected {batches * (new_tokens - 1)}")
    if sampled:
        _sampled_repeats(engine, requests[:per_prompt], done[:per_prompt])

    lm_prefill_parity(engine, requests, done, card, prompts, per_prompt,
                      logit_atol)
    if checks:
        lm_layer_checks(engine, requests[-per_prompt:], card)
    if profile:
        lm_profile(engine, requests[-per_prompt:], card)
    del engine, server, outcomes, done
    _phase_end(f"lm {arch}", card, t_phase)
    return launches["flash_attention_tc"] + launches["flash_attention"]


def _sampled_repeats(engine, batch, served) -> None:
    """The first batch holds a request at ``SAMPLE_TEMPERATURE``: served
    by the Server from engine seed 0, the batch must come out of
    ``generate(seed=0)`` again token for token (the sampled request
    too), and its sampled tokens must not all be the greedy ones."""
    again = engine.generate(batch, seed=0)
    for o, toks in zip(served, again):
        if not np.array_equal(o.value, toks):
            raise AssertionError(f"a rerun from the same seed gave {toks}, "
                                 f"the served run {o.value}")
    greedy = engine.generate([dataclasses.replace(batch[-1], temperature=0.0)],
                             seed=0)[0]
    same = int((greedy == again[-1]).sum())
    print(f"lm sampled request (temperature {SAMPLE_TEMPERATURE}): "
          f"{served[-1].value.tolist()} repeats from seed 0; greedy would "
          f"give {greedy.tolist()} ({same} of {len(greedy)} tokens equal)")
    if same == len(greedy):
        raise AssertionError("the sampled request drew the greedy tokens")


class _Routing:
    """Wraps ``repro_torch.nn.moe.route`` for a ``with`` block: records
    each MoE layer's top-k expert ids (``record``, a list to append to),
    or replays recorded ids, sliced along the sequence by ``positions``,
    with the weights computed from the current router logits at those
    ids (``replay``)."""

    def __init__(self, record: list | None = None,
                 replay: list | None = None, positions=slice(None)):
        self.record, self.replay, self.positions = record, replay, positions

    def __enter__(self):
        from repro_torch.nn import moe

        self.moe, self.orig = moe, moe.route
        calls = iter(self.replay) if self.replay is not None else None

        def route(p, x, cfg):
            if calls is None:
                idx, weights = self.orig(p, x, cfg)
                self.record.append(idx)
                return idx, weights
            idx = next(calls)[:, self.positions]
            vals = torch.gather(x.float() @ p["router"].float(), -1, idx)
            if cfg.moe.router_softmax_topk:
                return idx, torch.softmax(vals, dim=-1)
            return idx, torch.sigmoid(vals)

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def _routing_agreement(a: list, b: list) -> list[float]:
    """Per MoE layer, the share of (token, choice) entries of ``a``'s
    top-k sets that ``b``'s sets hold too."""
    shares = []
    for x, y in zip(a, b):
        same = (x[..., :, None] == y[..., None, :]).any(-1)
        shares.append(same.float().mean().item())
    return shares


def lm_prefill_parity(engine, requests, served, card: str,
                      prompts: tuple[int, ...], n: int,
                      logit_atol: float) -> None:
    """Time each prompt length's batch through both backends; the first
    batch's last-position logits must agree within ``logit_atol`` and
    ``LM_LOGIT_REL`` (MoE: against the reference run with the cuda run's
    routing replayed; the free-running agreement per layer printed), and
    its greedy requests' served first tokens must be their argmax."""
    from repro_torch.models import lm

    cfg = engine.cfg
    prefill_ms, logits, routes = {}, {}, {}
    for i, plen in enumerate(prompts):
        toks = torch.from_numpy(np.stack(
            [r.prompt for r in requests[i * n:(i + 1) * n]])).to(engine.device)
        for backend in ("cuda", "reference"):
            routes[backend] = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode(), _Routing(record=routes[backend]):
                out, _ = lm.prefill(engine.params, cfg, {"tokens": toks},
                                    engine.max_len, backend=backend)
            torch.cuda.synchronize()
            prefill_ms[(plen, backend)] = (time.perf_counter() - t0) * 1e3
            if i == 0:
                logits[backend] = out[:, 0].float()
            del out
        if i == 0 and cfg.moe is not None:
            first = dict(routes)
            with torch.inference_mode(), _Routing(replay=first["cuda"]):
                out, _ = lm.prefill(engine.params, cfg, {"tokens": toks},
                                    engine.max_len, backend="reference")
            logits["replayed"] = out[:, 0].float()
            del out
    print(f"lm prefill {cfg.name} ({card}, host clock, synchronized): "
          + ", ".join(f"{n}x{plen} {backend} {ms:.3f} ms"
                      for (plen, backend), ms in prefill_ms.items()))
    got = logits["cuda"]
    want = (n,) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()) \
        + (cfg.vocab_size,)
    if got.shape != want or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite "
                             f"or of the wrong shape")
    free = logits["reference"]
    gated = logits.get("replayed", free)
    err = (got - gated).abs().max().item()
    rel = ((got - gated).norm() / gated.norm()).item()
    top1 = (got.argmax(-1) == gated.argmax(-1)).float().mean().item()
    what = "routing replayed" if cfg.moe is not None else "free-running"
    print(f"lm parity ({cfg.name}, {n} x {prompts[0]} prompt tokens, "
          f"{cfg.param_dtype}, {what}): cuda vs reference prefill logits "
          f"max_abs_err {err:.4e} (tol {logit_atol}), rel norm {rel:.4e} "
          f"(tol {LM_LOGIT_REL}), top-1 agreement {top1:.2f}, |logit| max "
          f"{gated.abs().max().item():.3f}, std {gated.std().item():.3f}")
    if cfg.moe is not None:
        agree = _routing_agreement(first["cuda"], first["reference"])
        print(f"lm routing ({cfg.name}): cuda vs reference free-running "
              f"top-{cfg.moe.top_k} agreement per MoE layer "
              f"{[round(a, 5) for a in agree]}; free-running logits "
              f"max_abs_err {(got - free).abs().max().item():.4e}, rel norm "
              f"{((got - free).norm() / free.norm()).item():.4e}")
    if err > logit_atol or rel > LM_LOGIT_REL:
        raise AssertionError("cuda prefill logits disagree with the "
                             "reference backend")
    greedy = np.array([r.temperature == 0 for r in requests[:n]])
    served_first = np.array([o.value[0] for o in served[:n]])
    if not (served_first == got.argmax(-1).cpu().numpy())[greedy].all():
        raise AssertionError("served first tokens differ from the argmax "
                             "of the same prefill")


def lm_layer_checks(engine, batch, card: str) -> None:
    """On the card, at full width: the RG-LRU scan, the chunked SSD and
    the MoE dispatch and combine of the first such layer against float64
    (``RGLRU_REL``, ``SSD_REL``, ``MOE_REL``), then prefill + one decode
    step against the full forward (:func:`_handoff_check`)."""
    cfg = engine.cfg
    toks = torch.from_numpy(np.stack([r.prompt for r in batch[:2]])).to(
        engine.device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        if "rglru" in cfg.pattern:
            _rglru_float64_check(engine, toks)
        if "mamba2" in cfg.pattern:
            _ssd_float64_check(engine, toks)
        if cfg.moe is not None:
            _moe_float64_check(engine, toks)
        _handoff_check(engine, toks, card)
    torch.cuda.synchronize()
    print(f"lm checks {cfg.name}: {time.perf_counter() - t0:.1f} s")


def _rel_check(label: str, got: torch.Tensor, want: torch.Tensor,
               tol: float) -> None:
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"{label}: max_abs_err {err:.3e}, rel norm {rel:.3e} (tol {tol}), "
          f"|want| max {want.abs().max().item():.3f}")
    if not rel <= tol:
        raise AssertionError(f"{label}: relative norm {rel:.3e} above {tol}")


def _layer_input(engine, i: int, toks, norm: str = "ln1"):
    """The first layer's input hidden states normed by layer ``i``'s
    ``norm``: a full-width activation of the model's own distribution."""
    from repro_torch.models import lm
    from repro_torch.nn.layers import rms_norm

    x = lm._embed_in(engine.params, engine.cfg, {"tokens": toks})
    return rms_norm(x, engine.params["layers"][i][norm], engine.cfg.norm_eps)


def _rglru_float64_check(engine, toks) -> None:
    from repro_torch.nn import rglru
    from repro_torch.nn.layers import dense

    cfg = engine.cfg
    i = cfg.pattern.index("rglru")
    p = engine.params["layers"][i]["mixer"]
    h = _layer_input(engine, i, toks)
    xr = rglru._causal_conv(dense(h, p["w_x"]), p["conv_w"].to(h.dtype),
                            p["conv_b"].to(h.dtype))
    a, u = rglru._gates(p, xr, cfg)
    got = rglru.linear_scan(a, u)
    ad, ud = a.double(), u.double()
    want = torch.empty_like(ud)
    state = torch.zeros_like(ud[:, 0])
    for t in range(ud.shape[1]):
        state = ad[:, t] * state + ud[:, t]
        want[:, t] = state
    _rel_check(f"rglru scan, layer {i} {tuple(a.shape)} vs a float64 "
               f"sequential recurrence", got, want, RGLRU_REL)


def _ssd_float64_check(engine, toks) -> None:
    from repro_torch.nn import ssd

    cfg = engine.cfg
    i = cfg.pattern.index("mamba2")
    p = engine.params["layers"][i]["mixer"]
    _, _, xh, dtp, bg, cg = ssd._scan_inputs(p, _layer_input(engine, i, toks),
                                             cfg)
    y, final = ssd._ssd_scan(xh, dtp, p["A_log"], bg, cg, cfg)
    b, l, h, _ = xh.shape
    a = -torch.exp(p["A_log"].double())
    bh = ssd._heads_of_groups(bg.double(), h)
    ch = ssd._heads_of_groups(cg.double(), h)
    xd, dtd = xh.double(), dtp.double()
    state = torch.zeros((b, h, xh.shape[-1], bg.shape[-1]),
                        dtype=torch.float64, device=xh.device)
    want = torch.empty_like(xd)
    for t in range(l):
        state = state * torch.exp(dtd[:, t] * a)[..., None, None] \
            + (dtd[:, t, :, None] * xd[:, t])[..., None] * bh[:, t, :, None, :]
        want[:, t] = torch.einsum("bhpk,bhk->bhp", state, ch[:, t])
    _rel_check(f"ssd chunked scan, layer {i} x {tuple(xh.shape)} vs a "
               f"float64 state recurrence", y, want, SSD_REL)
    _rel_check("ssd final state", final, state, SSD_REL)


def _moe_float64_check(engine, toks) -> None:
    """The first MoE layer in float32 (its weights cast; TF32 off) against
    a per-token float64 loop that takes the same top-k ids and drops an
    entry by the reference's rule (per row and expert, entries in (token,
    choice) order past the capacity). Row 0 is a prompt; row 1 repeats
    its first token, so every token of it picks the same experts and each
    of them overflows its capacity. Checked at the first 32 tokens of
    each row and 32 tokens, evenly spread, of those that lost a choice."""
    import torch.nn.functional as F

    from repro_torch.nn import moe

    cfg = engine.cfg
    m = cfg.moe
    i = next(j for j in range(cfg.n_layers) if cfg.is_moe_layer(j))
    p = engine.params["layers"][i]["moe"]
    toks = torch.stack([toks[0], toks[0, :1].expand(toks.shape[1])])
    h = _layer_input(engine, i, toks, "ln2").float()
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float()) for k, v in p.items()}
    b, s, _ = h.shape
    top_idx, _ = moe.route(p32, h, cfg)
    got = moe.moe_apply(p32, h, cfg)
    del p32
    _, _, _, keep_tok, cap = moe.dispatch(top_idx, cfg, s)
    ids = top_idx.cpu().numpy()
    drop = np.zeros(ids.shape, bool)
    for r in range(b):
        flat = ids[r].reshape(-1)
        for e in range(m.num_experts):
            drop[r].reshape(-1)[np.nonzero(flat == e)[0][cap:]] = True
    if not np.array_equal(drop, ~keep_tok.cpu().numpy().reshape(ids.shape)):
        raise AssertionError("the dispatch drops other entries than the "
                             "capacity rule")

    f64: dict = {}   # each expert's weights in float64, made at first use

    def swiglu(key, x, *weights):
        if key not in f64:
            f64[key] = [w.double() for w in weights]
        w_gate, w_up, w_down = f64[key]
        return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down

    lost = list(zip(*np.nonzero(drop.any(-1))))
    if not lost:
        raise AssertionError("no entry dropped: the overflowing row did not "
                             "overflow")
    spread = [lost[j] for j in np.linspace(0, len(lost) - 1, 32).astype(int)]
    tokens = sorted(set(spread) | {(r, t) for r in range(b)
                                   for t in range(32)})
    want, have = [], []
    for r, t in tokens:
        x = h[r, t].double()
        vals = (x @ p["router"].double())[top_idx[r, t]]
        w = torch.softmax(vals, -1) if m.router_softmax_topk \
            else torch.sigmoid(vals)
        y = torch.zeros_like(x)
        for c, e in enumerate(ids[r, t]):
            if not drop[r, t, c]:
                y += w[c] * swiglu(int(e), x, p["w_gate"][e], p["w_up"][e],
                                   p["w_down"][e])
        for j in range(m.n_shared_experts):
            sp = p[f"shared_{j}"]
            y += swiglu(f"shared_{j}", x, sp["w_gate"], sp["w_up"],
                        sp["w_down"])
        want.append(y)
        have.append(got[r, t])
    print(f"moe layer {i} ({cfg.name}): capacity {cap} of {s} x "
          f"{m.top_k} entries a row, {int(drop.sum())} of {drop.size} "
          f"entries dropped ({int(drop.any(-1).sum())} tokens lose a choice)")
    del f64
    _rel_check(f"moe dispatch/combine at {len(tokens)} tokens vs a "
               f"per-token float64 loop", torch.stack(have),
               torch.stack(want), MOE_REL)


def _handoff_check(engine, toks, card: str) -> None:
    """Prefill over the prompt and one decode step must give the full
    forward's logits at the last prompt position and the next one
    (``LM_LOGIT_ATOL``, ``LM_LOGIT_REL``): the recurrent states and caches
    handed from prefill to decode. MoE at no-drop capacity (capacity
    factor = experts), as tests/test_lm_consistency.py, with the forward's
    routing replayed, so that a near tie decided otherwise by the two
    paths' bf16 roundings moves no choice."""
    from repro_torch.models import lm

    cfg = engine.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    b, s = toks.shape[:2]
    nxt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, 1) + toks.shape[2:]).astype(np.int32)).to(
        toks.device)
    seq = torch.cat([toks, nxt], dim=1)
    rec: list = []
    with _Routing(record=rec):
        full = lm.forward(engine.params, cfg, {"tokens": seq})
    with _Routing(replay=rec, positions=slice(0, s)):
        first, caches = lm.prefill(engine.params, cfg, {"tokens": toks},
                                   engine.max_len)
    with _Routing(replay=rec, positions=slice(s, s + 1)):
        step, _ = lm.decode_step(engine.params, cfg,
                                 {"tokens": nxt, "pos": s}, caches)
    for label, pos, got in (("prefill", s - 1, first), ("decode", s, step)):
        _logits_close(f"lm handoff ({cfg.name}, {card}): {label} at position "
                      f"{pos} of a {s}-token prompt vs the forward",
                      got[:, 0], full[:, pos], LM_LOGIT_ATOL)
    del full, caches


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


def _mrope_ids(b: int, n_text: int, gh: int, gw: int,
               n_after: int) -> torch.Tensor:
    """(3, b, S) int32 M-RoPE ids laid out as Qwen2-VL's ``get_rope_index``
    does (arXiv:2409.12191 §2.1): ``n_text`` text positions with equal
    (t, h, w) ids, a gh x gw image grid at one temporal id with h and w
    running over the grid, then ``n_after`` text positions from the
    largest id + 1. The three rows differ on the grid."""
    text = np.arange(n_text)
    r, c = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    start = n_text + max(gh, gw)
    after = np.arange(start, start + n_after)
    rows = [np.concatenate([text, np.full(gh * gw, n_text), after]),
            np.concatenate([text, n_text + r.ravel(), after]),
            np.concatenate([text, n_text + c.ravel(), after])]
    one = torch.from_numpy(np.stack(rows).astype(np.int32))   # (3, S)
    return one[:, None].expand(3, b, one.shape[1]).contiguous()


def vlm_serve_phase(card: str, device: str = "cuda") -> int:
    """Phase 6a: qwen2-vl-2b at full width and depth, served by
    ``lm.prefill`` and ``lm.decode_step`` (the engine takes token inputs
    only, as the reference's): ``VLM_BATCH`` prompts of frontend
    embeddings under image-grid M-RoPE ids, then ``LM_NEW_TOKENS`` decode
    steps. Returns the tensor-core kernel's launches of the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    _setup(cfg, params, t0, "vlm")
    b, new = VLM_BATCH, LM_NEW_TOKENS
    grid = _mrope_ids(b, *VLM_GRID).to(device)
    s = grid.shape[2]
    max_len = s + new + 1
    emb = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s + new, cfg.d_model)).astype(np.float32)).to(device)
    prompt = {"embeddings": emb[:, :s], "positions": grid}
    with torch.inference_mode():
        torch.cuda.synchronize()
        _lib.reset_launches()
        prefill_ms = []     # the first call cold, the second warm
        for _ in range(2):
            t0 = time.perf_counter()
            logits, caches = lm.prefill(params, cfg, prompt, max_len)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        launches = _lib.launches()
        _check_launches(f"vlm prefill {b}x{s}", cfg, launches, 2)
        decode_ms = []
        for t in range(new):
            t0 = time.perf_counter()
            step, caches = lm.decode_step(
                params, cfg, {"embeddings": emb[:, s + t:s + t + 1],
                              "pos": s + t}, caches)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            if step.shape != (b, 1, cfg.vocab_size) \
                    or not torch.isfinite(step).all():
                raise AssertionError(f"decode step {t}: logits "
                                     f"{tuple(step.shape)} not finite")
        print(f"vlm serve {cfg.name} ({card}, host clock, synchronized): "
              f"prefill {b} x {s} embedding rows {prefill_ms[1]:.3f} ms "
              f"(cold {prefill_ms[0]:.3f}), "
              f"{new} decode steps median {np.median(decode_ms):.3f} ms "
              f"(first {decode_ms[0]:.3f}); launches {launches}")
        ref, _ = lm.prefill(params, cfg, prompt, max_len,
                            backend="reference")
        _logits_close(f"vlm parity ({cfg.name}, {b} x {s}, image-grid "
                      f"M-RoPE): cuda vs reference prefill logits",
                      logits[:, 0], ref[:, 0], LM_LOGIT_ATOL)
        flat, _ = lm.prefill(params, cfg, {"embeddings": emb[:, :s]},
                             max_len)
        moved = (flat[:, 0].float() - logits[:, 0].float()).abs().max()
        print(f"vlm M-RoPE: degenerate ids (t = h = w) move the last "
              f"position's logits by {moved.item():.4e} (max abs)")
        if not moved > LM_LOGIT_ATOL:
            raise AssertionError("the h and w rows of the M-RoPE ids do not "
                                 "reach the logits")
        del ref, flat, caches
        # prefill + one decode step against the full forward, whose last
        # position carries the ids (s, s, s) that decode rotates by
        last = torch.full((3, 2, 1), s, dtype=torch.int32, device=device)
        full = lm.forward(params, cfg, {
            "embeddings": emb[:2, :s + 1],
            "positions": torch.cat([grid[:, :2], last], dim=2)})
        first, two = lm.prefill(params, cfg, {"embeddings": emb[:2, :s],
                                              "positions": grid[:, :2]},
                                max_len)
        step, _ = lm.decode_step(params, cfg, {"embeddings": emb[:2, s:s + 1],
                                               "pos": s}, two)
        _logits_close(f"vlm handoff ({card}): prefill at position {s - 1} vs "
                      f"the forward", first[:, 0], full[:, s - 1],
                      LM_LOGIT_ATOL)
        _logits_close(f"vlm handoff ({card}): decode at position {s} vs the "
                      f"forward", step[:, 0], full[:, s], LM_LOGIT_ATOL)
        del full, first, two, step
        state = {}

        def prefill():
            state["caches"] = lm.prefill(params, cfg, prompt, max_len)[1]

        def decode():
            lm.decode_step(params, cfg, {"embeddings": emb[:, s:s + 1],
                                         "pos": s}, state["caches"])

        _profile(prefill, f"vlm prefill {b}x{s}", card)
        _profile(decode, f"vlm decode step (batch {b})", card)
    del params, emb, state, logits
    _phase_end(f"lm {VLM_ARCH}", card, t_phase)
    return launches["flash_attention_tc"] // 2


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """The leaves' paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _lm_grads(params, cfg, batch, backend: str):
    """(loss, gradients in ``tree_leaves`` order) of ``lm.loss_fn`` with
    remat, as the train step takes them."""
    from repro_torch.models import lm
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch, remat=True,
                      backend=backend)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _grad_parity(label: str, params, cfg, batch, tol: float) -> dict:
    """Step-0 gradients through the kernels against the ``reference``
    backend: the losses within ``LM_LOSS_ATOL`` and every leaf within
    ``tol`` (relative norm), the worst five printed. Returns the kernel
    launches of the cuda pass."""
    from repro_torch.kernels import _lib

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    loss_c, g_c = _lm_grads(params, cfg, batch, "cuda")
    torch.cuda.synchronize()
    cuda_ms = (time.perf_counter() - t0) * 1e3
    launches = _lib.launches()
    t0 = time.perf_counter()
    loss_r, g_r = _lm_grads(params, cfg, batch, "reference")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    rels = []
    for name, a, b in zip(_leaf_names(params), g_c, g_r):
        a, b = a.float(), b.float()
        rels.append((((a - b).norm() / b.norm().clamp_min(1e-30)).item(),
                     name, b.norm().item()))
    del g_c, g_r
    worst = sorted(rels, reverse=True)[:5]
    print(f"{label}: loss cuda {loss_c.item():.6f} reference "
          f"{loss_r.item():.6f} (tol {LM_LOSS_ATOL}); loss + gradients "
          f"{cuda_ms:.1f} ms cuda, {ref_ms:.1f} ms reference (host clock); "
          f"gradient rel norm over {len(rels)} leaves, worst five "
          + ", ".join(f"{n} {r:.3e} (|g| {g:.3e})" for r, n, g in worst)
          + f" (tol {tol})")
    if not abs(loss_c.item() - loss_r.item()) <= LM_LOSS_ATOL:
        raise AssertionError(f"{label}: losses disagree")
    if not worst[0][0] <= tol:
        raise AssertionError(f"{label}: gradient of {worst[0][1]} off by "
                             f"{worst[0][0]:.3e}")
    return launches


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _digest(tree) -> list[tuple[int, int]]:
    """A bitwise fingerprint of every leaf: the sums of its bits (read as
    integers) and of its bits weighted by position (int64 sums in
    chunks; a wraparound is as deterministic as the rest)."""
    from repro_torch.training.optimizer import tree_leaves

    out = []
    for t in tree_leaves(tree):
        flat = t.detach().reshape(-1).view(_BITS[t.element_size()])
        s1 = s2 = 0
        for i in range(0, flat.numel(), 1 << 24):
            bits = flat[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i, i + bits.numel(), device=bits.device) % 251
            s1 += int(bits.sum())
            s2 += int((bits * (w + 1)).sum())
        out.append((s1, s2))
    return out


def _state(params, opt_state) -> tuple:
    return params, opt_state["m"], opt_state["v"], opt_state["step"]


def _probed(step_fn, rec: dict, *, digest_after=(), digest_before=(),
            preempt_after: int | None = None):
    """``step_fn`` that records, per step index i (the optimizer's step
    count before it), the loss, kernel launches and synchronized host
    ms; digests of the state before step i for i in ``digest_before``
    and after it for i + 1 in ``digest_after``; and sends itself SIGTERM
    after step ``preempt_after`` - 1, as a preemption would (the
    TrainLoop then saves and stops)."""
    import signal

    from repro_torch.kernels import _lib

    def step(params, opt_state, batch):
        i = int(opt_state["step"])
        if i in digest_before:
            rec.setdefault("before", {})[i] = _digest(_state(params,
                                                             opt_state))
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        rec.setdefault("ms", []).append((time.perf_counter() - t0) * 1e3)
        rec.setdefault("launches", []).append(_lib.launches())
        rec.setdefault("loss", {})[i] = loss
        if i + 1 in digest_after:
            rec.setdefault("after", {})[i + 1] = _digest(_state(params,
                                                                opt_state))
        if preempt_after == i + 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return params, opt_state, metrics

    return step


def _train_batch(cfg, b: int, s: int, device, grid=None) -> dict:
    """A training batch from seed 0 as ``launch/train.py`` makes one:
    random labels, the tokens equal to them (or random frontend
    embeddings with ``grid``'s M-RoPE ids for an embedding-input
    config)."""
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).to(device)
    if cfg.input_mode != "embeddings":
        return {"tokens": labels, "labels": labels}
    emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return {"embeddings": torch.from_numpy(emb).to(device=device,
                                                   dtype=cfg.cdtype),
            "positions": _mrope_ids(b, *grid).to(device), "labels": labels}


def lm_train_phase(card: str, device: str = "cuda") -> dict:
    """Phase 6c: qwen2.5-3b trained at full width and depth through the
    kernels (``make_train_step(remat=True)`` under ``TrainLoop``): the
    step-0 gradients against the ``reference`` backend in bf16 and, at 2
    of 36 layers, in float32; ``TRAIN_LM_STEPS`` steps on one fixed
    batch; a preemption after step ``TRAIN_CKPT_STEP`` saved by the loop
    and resumed by a new one; one step profiled. Returns the
    flash_attention launches of the uninterrupted run and of the float32
    check."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig, tree_map
    from repro_torch.training.train_loop import (TrainLoop, init_train_state,
                                                 make_train_step)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_LM_BATCH
    opt_cfg = AdamWConfig(lr=TRAIN_LM_LR, warmup_steps=1,
                          total_steps=TRAIN_LM_STEPS)

    def fresh(seed: int = 0):
        return init_train_state(cfg, opt_cfg,
                                torch.Generator(device).manual_seed(seed))

    t0 = time.perf_counter()
    params, opt_state = fresh()
    torch.cuda.synchronize()
    _setup(cfg, params, t0, "lm train")
    state_gb = _nbytes(*_leaves((params, opt_state["m"],
                                 opt_state["v"]))) / 1e9
    # the resumed run's template: a restore takes only each leaf's dtype
    # and device from it, so empty leaves keep the card from holding a
    # second state beside the restored one
    template = tree_map(lambda t: t.new_empty(0), (params, opt_state))
    batch = _train_batch(cfg, b, s, device)
    launches = _grad_parity(f"lm train step 0 ({cfg.name}, {b} x {s}, "
                            f"{cfg.param_dtype}, remat)", params, cfg, batch,
                            LM_GRAD_REL)
    _check_launches("lm train gradients", cfg, launches, 2)

    f32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    p32 = lm.init_params(f32, torch.Generator(device).manual_seed(0))
    f32_launches = _grad_parity(
        f"lm train step 0 float32 ({TRAIN_F32_LAYERS} of {cfg.n_layers} "
        f"layers, {TRAIN_F32_BATCH[0]} x {TRAIN_F32_BATCH[1]})", p32, f32,
        _train_batch(f32, *TRAIN_F32_BATCH, device), GRAD_REL)
    _check_launches("lm train float32 gradients", f32, f32_launches, 2)
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    step_fn = make_train_step(cfg, opt_cfg, remat=True, donate=True)
    ckpt = TRAIN_CKPT_STEP
    first: dict = {}
    loop = TrainLoop(cfg, opt_cfg, lambda step: batch, log_every=1)
    params, opt_state, _ = loop.run(
        params, opt_state, TRAIN_LM_STEPS, log=print,
        train_step=_probed(step_fn, first, digest_after=(ckpt, ckpt + 1)))
    losses = [first["loss"][i] for i in range(TRAIN_LM_STEPS)]
    for i, got in enumerate(first["launches"]):
        _check_launches(f"lm train step {i}", cfg, got, 2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm train {cfg.name} ({card}): {TRAIN_LM_STEPS} steps of {b} x "
          f"{s} tokens, losses {[round(x, 5) for x in losses]}; step ms "
          f"(synchronized) {[round(x, 1) for x in first['ms']]}, median "
          f"{np.median(first['ms']):.1f} ms; {first['launches'][0]} "
          f"launches a step; peak device memory {peak:.2f} GB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"lm train losses {losses}: not finite or not "
                             f"falling")

    # one more step with the AdamW update timed alone, then one profiled
    adamw = train_loop.adamw_update
    update_ms = []

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = adamw(*args, **kw)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    train_loop.adamw_update = timed_update
    try:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train_loop.adamw_update = adamw
    print(f"lm train AdamW update ({card}, host clock, synchronized): "
          f"{update_ms[0]:.1f} ms of a {step_ms:.1f} ms step "
          f"({update_ms[0] / step_ms:.3f})")
    _profile(lambda: step_fn(params, opt_state, batch),
             f"lm train step {b}x{s}", card)
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=3, async_save=True)
        saved: dict = {}
        t0 = time.perf_counter()
        out = TrainLoop(cfg, opt_cfg, lambda step: batch, ckpt_manager=mgr,
                        ckpt_every=50, log_every=1).run(
            *fresh(), TRAIN_LM_STEPS, log=print,
            train_step=_probed(step_fn, saved, digest_after=(ckpt,),
                               preempt_after=ckpt))
        del out
        gc.collect()
        mgr.wait()
        save_s = time.perf_counter() - t0
        if mgr.latest_step() != ckpt or len(saved["loss"]) != ckpt:
            raise AssertionError(f"the preempted run saved step "
                                 f"{mgr.latest_step()} after "
                                 f"{len(saved['loss'])} steps")
        same = saved["after"][ckpt] == first["after"][ckpt]
        print(f"lm checkpoint ({card}): preempted after step {ckpt}; the "
              f"{ckpt} steps and the async save of {state_gb:.2f} GB took "
              f"{save_s:.1f} s; its state "
              f"{'equals' if same else 'DIFFERS from'} the uninterrupted "
              f"run's bit for bit")
        resumed: dict = {}
        t0 = time.perf_counter()
        out = TrainLoop(cfg, opt_cfg, lambda step: batch, ckpt_manager=mgr,
                        ckpt_every=50, log_every=1).run(
            *template, ckpt + 1, log=print,
            train_step=_probed(step_fn, resumed, digest_before=(ckpt,),
                               digest_after=(ckpt + 1,)))
        del out
        resume_s = time.perf_counter() - t0
    restored = resumed["before"][ckpt] == saved["after"][ckpt]
    loss_diff = resumed["loss"][ckpt] - first["loss"][ckpt]
    step_same = resumed["after"][ckpt + 1] == first["after"][ckpt + 1]
    print(f"lm resume ({card}): a new TrainLoop restored step {ckpt} "
          f"({'bit for bit' if restored else 'NOT bit for bit'}) and ran "
          f"step {ckpt + 1} in {resume_s:.1f} s: loss "
          f"{resumed['loss'][ckpt]:.6f} vs uninterrupted "
          f"{first['loss'][ckpt]:.6f} (difference {loss_diff:.3e}); state "
          f"after it {'equals' if step_same else 'DIFFERS from'} the "
          f"uninterrupted run's")
    if not (restored and loss_diff == 0 and step_same):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    _phase_end(f"lm train {TRAIN_ARCH}", card, t_phase)
    return {"lm_train_launches": sum(x["flash_attention_tc"]
                                     for x in first["launches"]),
            "lm_train_f32_launches": f32_launches["flash_attention"]}


def vlm_train_phase(card: str, device: str = "cuda") -> int:
    """Phase 6d: qwen2-vl-2b trained at full width and depth with int8
    gradient compression and error feedback, ``VLM_TRAIN_STEPS`` steps of
    image-grid embedding batches; step-0 gradients against the
    ``reference`` backend. Returns the flash_attention launches of the
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.training.compression import wire_bytes_saved
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM_ARCH)
    b, s = TRAIN_LM_BATCH
    opt_cfg = AdamWConfig(lr=TRAIN_LM_LR, warmup_steps=1,
                          total_steps=VLM_TRAIN_STEPS)
    t0 = time.perf_counter()
    params, opt_state = init_train_state(
        cfg, opt_cfg, torch.Generator(device).manual_seed(0),
        compress_grads=True)
    torch.cuda.synchronize()
    _setup(cfg, params, t0, "vlm train")
    batch = _train_batch(cfg, b, s, device, grid=VLM_TRAIN_GRID)
    _grad_parity(f"vlm train step 0 ({cfg.name}, {b} x {s} image-grid "
                 f"embeddings, remat)", params, cfg, batch, LM_GRAD_REL)
    step_fn = make_train_step(cfg, opt_cfg, remat=True, compress_grads=True,
                              donate=True)
    rec: dict = {}
    probe = _probed(step_fn, rec)
    for i in range(VLM_TRAIN_STEPS):
        params, opt_state, _ = probe(params, opt_state, batch)
        if i == 0 and not any(e.abs().max() > 0
                              for e in tree_leaves(opt_state["ef"])):
            raise AssertionError("the error feedback is zero after step 1")
        _check_launches(f"vlm train step {i}", cfg, rec["launches"][i], 2)
    losses = [rec["loss"][i] for i in range(VLM_TRAIN_STEPS)]
    ef = max(e.abs().max().item() for e in tree_leaves(opt_state["ef"]))
    print(f"vlm train {cfg.name} ({card}, int8 gradients with error "
          f"feedback): losses {[round(x, 5) for x in losses]}, step ms "
          f"(synchronized) {[round(x, 1) for x in rec['ms']]}; largest "
          f"|ef| {ef:.3e}; wire bytes saved a step "
          f"{wire_bytes_saved(params) / 1e9:.3f} GB (the data-parallel "
          f"all-reduce's payload; nothing crosses a wire on one card)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"vlm train losses {losses} not finite")
    del params, opt_state
    _phase_end(f"vlm train {VLM_ARCH}", card, t_phase)
    return sum(x["flash_attention_tc"] for x in rec["launches"])


def _restack(params, cfg) -> dict:
    """``params`` in the scanned layout (as tests/test_archs.py restacks
    them): p groups of stacked layer trees and the trailing layers."""
    from repro_torch.models import lm

    p = lm.pattern_period(cfg)
    nf = cfg.n_layers // p

    def stack(*trees):
        if isinstance(trees[0], dict):
            return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
        return torch.stack(trees)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["stack"] = tuple(stack(*(params["layers"][j + k * p]
                                 for k in range(nf))) for j in range(p))
    out["trail"] = params["layers"][nf * p:]
    return out


def scanned_phase(card: str, device: str = "cuda") -> int:
    """Phase 6e: recurrentgemma-2b's scanned forward at full width and
    depth (period 3: 8 stacked groups and 2 trailing layers) against the
    unrolled forward, and the scanned loss against the unrolled one, on
    ``SCAN_BATCH`` tokens. Returns the flash_attention launches (all on
    the tensor-core kernel, recurrentgemma's bf16 route at dh 256)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SCAN_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    _setup(cfg, params, t0, "scanned")
    scanned = _restack(params, cfg)
    period = lm.pattern_period(cfg)
    print(f"scanned layout: period {period}, {cfg.n_layers // period} "
          f"stacked groups, {len(scanned['trail'])} trailing layers")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, SCAN_BATCH)
                            .astype(np.int32)).to(device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        full = lm.forward(params, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scan = lm.forward_scanned(scanned, cfg, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        err = (scan.float() - full.float()).abs().max().item()
        del full, scan
        loss = lm.loss_fn(params, cfg, batch)
        loss_s = lm.loss_fn_scanned(scanned, cfg, batch)
        launches = _lib.launches()
    d_loss = abs(loss_s.item() - loss.item())
    print(f"scanned forward ({cfg.name}, {SCAN_BATCH[0]} x {SCAN_BATCH[1]} "
          f"tokens, {card}): logits max_abs_err vs the unrolled forward "
          f"{err:.4e} (tol {SCAN_ATOL}); loss {loss_s.item():.6f} vs "
          f"{loss.item():.6f} (difference {d_loss:.3e}); forward "
          f"{(t1 - t0) * 1e3:.1f} ms unrolled, {(t2 - t1) * 1e3:.1f} ms "
          f"scanned (host clock, synchronized); launches {launches}")
    if not (err <= SCAN_ATOL and d_loss <= SCAN_ATOL):
        raise AssertionError("the scanned forward disagrees with the "
                             "unrolled one")
    _check_launches("scanned phase", cfg, launches, 4)
    del params, scanned
    _phase_end(f"scanned {SCAN_ARCH}", card, t_phase)
    return launches["flash_attention_tc"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_run(step_fn, params, opt_state, batch, steps: int) -> dict:
    """``steps`` steps of ``step_fn`` on ``batch``: losses, synchronized
    host ms and kernel launches per step."""
    from repro_torch.kernels import _lib

    rec: dict = {"loss": [], "ms": [], "launches": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        rec["loss"].append(metrics["loss"].item())
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append(_lib.launches())
    rec["state"] = (params, opt_state)
    return rec


def sharded_train_phase(card: str, device: str = "cuda") -> dict:
    """Phase 7a: phase 6c's qwen2.5-3b train step (seed 0, its batch,
    remat, donating) for ``SHARDED_STEPS`` steps unsharded, then through
    ``make_train_step(rules=...)`` on DTensors of a 1 x 1 NCCL
    ``DeviceMesh`` from ``init_train_state(rules=...)`` (the launcher's
    sharded draw, the same seed): losses and the updated parameters and moments bit for
    bit equal, 72 tensor-core attention launches a step and no
    CUDA-core one; step ms of both (the difference is DTensor's host
    cost), one sharded step profiled (idle share), the sharded run's
    peak memory. Returns the sharded run's launches and its measured
    peak (bytes) for phase 7b."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.dist.shardings import ShardingRules
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_LM_BATCH
    opt_cfg = AdamWConfig(lr=TRAIN_LM_LR, warmup_steps=1,
                          total_steps=TRAIN_LM_STEPS)

    def fresh(rules=None):
        return init_train_state(cfg, opt_cfg,
                                torch.Generator(device).manual_seed(0),
                                rules=rules)

    batch = _train_batch(cfg, b, s, device)
    plain = _train_run(make_train_step(cfg, opt_cfg, remat=True,
                                       donate=True),
                       *fresh(), batch, SHARDED_STEPS)
    p0, o0 = plain.pop("state")
    want_params = [t.cpu() for t in tree_leaves(p0)]
    want_moments = _digest((o0["m"], o0["v"]))
    del p0, o0
    gc.collect()
    torch.cuda.empty_cache()

    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, opt_state = fresh(rules)
        step_fn = make_train_step(cfg, opt_cfg, rules, remat=True,
                                  donate=True)
        sharded = _train_run(step_fn, params, opt_state, batch,
                             SHARDED_STEPS)
        peak = torch.cuda.max_memory_allocated() - base
        params, opt_state = sharded.pop("state")
        placements = {str(p) for t in tree_leaves((params, opt_state["m"]))
                      for p in t.placements}
        got = [t.to_local() for t in tree_leaves(params)]
        errs = [(got_t.float() - want_t.to(got_t.device).float()).abs()
                .max().item() for got_t, want_t in zip(got, want_params)]
        same_moments = _digest((_local_tree(opt_state["m"]),
                                _local_tree(opt_state["v"]))) \
            == want_moments
        print(f"sharded train {cfg.name} ({card}): {SHARDED_STEPS} steps of "
              f"{b} x {s} on a 1 x 1 {backend} DeviceMesh, placements "
              f"{sorted(placements)}; losses {sharded['loss']} vs unsharded "
              f"{plain['loss']}; parameters "
              f"{'bit for bit' if max(errs) == 0 else 'NOT bit for bit'} "
              f"(max abs err {max(errs):.3e} over {len(errs)} leaves); "
              f"moments {'bit for bit' if same_moments else 'DIFFER'}")
        if sharded["loss"] != plain["loss"] or max(errs) != 0 \
                or not same_moments:
            worst = sorted(enumerate(errs), key=lambda x: -x[1])[:5]
            raise AssertionError(f"the sharded steps differ from the "
                                 f"unsharded ones: worst leaves {worst}")
        for i, got_l in enumerate(sharded["launches"]):
            _check_launches(f"sharded train step {i}", cfg, got_l, 2)
        print(f"sharded train step ms ({card}, synchronized host clock): "
              f"unsharded {[round(x, 1) for x in plain['ms']]}, sharded "
              f"{[round(x, 1) for x in sharded['ms']]}; median after the "
              f"first {np.median(plain['ms'][1:]):.1f} vs "
              f"{np.median(sharded['ms'][1:]):.1f} ms (DTensor's host cost "
              f"{np.median(sharded['ms'][1:]) - np.median(plain['ms'][1:]):+.1f}"
              f" ms); peak device memory of the sharded run "
              f"{peak / 1e9:.2f} GB")
        _profile(lambda: step_fn(params, opt_state, batch),
                 f"sharded train step {b}x{s}", card)
        del params, opt_state, got
    finally:
        dist.destroy_process_group()
    _phase_end(f"sharded train {TRAIN_ARCH}", card, t_phase)
    return {"launches": sum(x["flash_attention_tc"]
                            for x in sharded["launches"]),
            "peak": peak}


def _local_tree(tree):
    """The local tensors of a tree of DTensors."""
    from repro_torch.training.optimizer import tree_map

    return tree_map(lambda t: t.to_local(), tree)


def estimate_phase(card: str, measured_peak: float) -> None:
    """Phase 7b: the dry-run's tracker on phase 7a's step (qwen2.5-3b,
    ``TRAIN_LM_BATCH``, remat, donating) on a fake 1 x 1 mesh: its
    predicted peak against 7a's measured one, within ``ESTIMATE_RATIO``
    either way."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_train_step

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_LM_BATCH
    rec = trace_train_step(cfg, (1, 1), b, s)
    predicted = rec["memory"]["peak_bytes"]
    ratio = predicted / measured_peak
    print(f"memory estimate ({card}): the dry-run predicts a peak of "
          f"{predicted / 1e9:.2f} GB for 7a's step (arguments "
          f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB), the card "
          f"measured {measured_peak / 1e9:.2f} GB: ratio {ratio:.3f}; "
          f"flops/dev {rec['flops_per_device']:.4e}; traced in "
          f"{time.perf_counter() - t0:.1f} s")
    if not 1 / ESTIMATE_RATIO <= ratio <= ESTIMATE_RATIO:
        raise AssertionError(f"the estimate is off by more than "
                             f"{ESTIMATE_RATIO}x: the tracker misses a "
                             f"class of tensors")


def dryrun_phase(card: str) -> None:
    """Phase 7c: ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_CELLS``, one subprocess a cell, all started together; each
    record's summary and whether its per-device peak fits one card. Any
    error record, non-zero exit or timeout fails the phase."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as out:
        procs = [(cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for cell in DRYRUN_CELLS]
        failed = []
        for cell, proc in procs:
            try:
                log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed.append((cell, "timeout"))
                continue
            path = pathlib.Path(out) / f"{cell[0]}__{cell[1]}__{cell[2]}.json"
            if proc.returncode != 0 or not path.exists():
                failed.append((cell, log[-2000:]))
                continue
            rec = json.loads(path.read_text())
            if rec["status"] != "ok":
                failed.append((cell, rec.get("error")))
                continue
            from repro_torch.launch.dryrun import mem_per_device, summary

            mem = mem_per_device(rec)
            coll = rec["costs"]["collectives"]
            top_bytes, top = rec["proof"]["memory"]["peak_top"][0]
            print(f"dryrun {summary(rec)} fits one H100 ({H100_BYTES / 1e9:.0f}"
                  f" GB): {'yes' if mem <= H100_BYTES else 'NO'}; "
                  f"collective counts {coll['counts']}; bytes accessed/dev "
                  f"{rec['costs']['bytes_accessed_per_device']:.3e}; "
                  f"{rec['devices']} devices; largest at the peak "
                  f"{top_bytes / 2**30:.3f} GiB {top}")
    for p in procs:
        if p[1].poll() is None:
            p[1].kill()
    print(f"dryrun phase wall time ({card}): {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"dry-run cells failed: {failed}")


def check_backend_env() -> None:
    """Fail if a ``REPRO_KERNEL_BACKEND*`` variable is set: it would route
    ops of the whole run to other backends than the kernels."""
    stray = sorted(k for k in os.environ
                   if k.startswith("REPRO_KERNEL_BACKEND"))
    if stray:
        raise SystemExit(f"chip_smoke: {stray} set; the run must reach the "
                         f"kernels through the default backend")


def main() -> None:
    check_backend_env()
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
    paper_launches = paper_phase(dev, card, kernels)
    oracle_launches = oracle_phase(dev, card)

    attention_kernel_phase(torch.device("cuda"), kernels)
    flash = kernels["flash_attention"]
    flash["launches"] = lm_serve_phase(card)
    flash["minicpm_launches"] = lm_serve_phase(
        card, MINICPM_ARCH, prompts=(1024,), logit_atol=MINICPM_LOGIT_ATOL,
        profile=False)
    flash["command_r_launches"] = lm_serve_phase(
        card, COMMAND_R_ARCH, prompts=(1024,), per_prompt=2, new_tokens=5,
        n_layers=COMMAND_R_LAYERS, profile=False)
    flash["qwen2_moe_launches"] = lm_serve_phase(
        card, QWEN_MOE_ARCH, prompts=(1024,), sampled=True, checks=True)
    flash["llama4_scout_launches"] = lm_serve_phase(
        card, LLAMA4_ARCH, prompts=(1024,), per_prompt=2, new_tokens=5,
        n_layers=LLAMA4_LAYERS, checks=True)
    flash["recurrentgemma_launches"] = lm_serve_phase(
        card, RG_ARCH, prompts=(1024, 2048), checks=True)
    flash["mamba2_launches"] = lm_serve_phase(
        card, MAMBA_ARCH, prompts=(1024,), checks=True)
    flash["qwen2_vl_serve_launches"] = vlm_serve_phase(card)
    flash["musicgen_launches"] = lm_serve_phase(
        card, MUSICGEN_ARCH, prompts=(1024,), sampled=True)
    flash.update(lm_train_phase(card))
    flash["qwen2_vl_train_launches"] = vlm_train_phase(card)
    flash["scanned_launches"] = scanned_phase(card)
    sharded = sharded_train_phase(card)
    flash["sharded_train_launches"] = sharded["launches"]
    estimate_phase(card, sharded["peak"])
    dryrun_phase(card)
    for name, row in kernels.items():       # every row, flash_attention's too
        row["train_step_launches"] = train_launches.get(name, 0)
        row["stream_launches"] = stream_launches.get(name, 0)
        row["tune_launches"] = tune_launches.get(name, 0)
        row["mesh_launches"] = mesh_launches.get(name, 0)
        row["analyze_launches"] = analyze_launches.get(name, 0)
        row["paper_launches"] = paper_launches.get(name, 0)
        row["oracle_launches"] = oracle_launches.get(name, 0)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
