"""The dry-run's per-device memory estimate held against a sharded train
step on real cards.

    PYTHONPATH=src python -m repro_torch.launch.peak_check \\
        --arch qwen2.5-3b --mesh 2x2 --mesh 1x4 --batch 8 --seq 1024

For each ``--mesh`` (data x model; as many cards as ranks) it traces one
train step of ``--arch`` with the dry-run's tracker
(``dryrun.trace_train_step``: a fake process group, meta tensors, rank
0's shards), then runs the same
step on the cards: one process a card, an NCCL group, the state drawn by
``init_train_state(rules=...)`` and ``--steps`` steps of
``make_train_step(rules=..., remat=True, donate=True)`` on one batch. It
prints each rank's measured peak (``torch.cuda.max_memory_allocated``
less what was allocated before the state was drawn) and losses beside
the estimate, the ratio, the largest storages the tracker saw live at
its peak, and one JSON line of the numbers; it exits 1 when a rank's
ratio leaves [1/2, 2] (the bound of ``chip_smoke.py``'s phase 7b).
``--device cpu`` rehearses the path with gloo, where no peak is
measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import queue as queue_mod
import socket
import sys
import time
import traceback

import numpy as np
import torch

NAMES = ("data", "model")
RATIO = 2.0
TIMEOUT_S = 600   # for all of a mesh's ranks to report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--mesh", action="append", default=[],
                    help="data x model, e.g. 2x2 (repeatable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def config(args):
    from repro_torch.configs.registry import get_config, get_smoke

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  block_pattern=cfg.pattern[:args.layers])
    return cfg


def _batch(cfg, b: int, s: int, device) -> dict:
    labels = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)
    return {"tokens": labels, "labels": labels}


def _progress(rank: int, what: str) -> None:
    print(f"  [rank {rank}] {what}", file=sys.stderr, flush=True)


def rank_main(rank: int, world: int, port: int, args, shape: tuple,
              results) -> None:
    """One rank: the sharded steps; puts (rank, peak bytes or None,
    losses) or (rank, "error", traceback) on ``results``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.shardings import ShardingRules
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    cuda = args.device == "cuda"
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = config(args)
        rules = ShardingRules(init_device_mesh(device.type, shape,
                                               mesh_dim_names=NAMES))
        opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=1,
                              total_steps=args.steps)
        batch = _batch(cfg, args.batch, args.seq, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, opt_state = init_train_state(
            cfg, opt_cfg, torch.Generator(device).manual_seed(0),
            rules=rules)
        _progress(rank, f"state drawn in {time.perf_counter() - t0:.1f} s")
        step = make_train_step(cfg, opt_cfg, rules, remat=True, donate=True)
        losses = []
        for i in range(args.steps):
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            _progress(rank, f"step {i} in {time.perf_counter() - t0:.1f} s")
        peak = None
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        results.put((rank, peak, losses))
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        results.put((rank, "error", traceback.format_exc()[-3000:]))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_mesh(args, cfg, shape: tuple) -> dict:
    """The estimate and the ranks' readings on one mesh."""
    import multiprocessing

    from repro_torch.launch.dryrun import trace_train_step

    est = trace_train_step(cfg, shape, args.batch, args.seq)
    world = math.prod(shape)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, args, shape, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, peak, losses = results.get(timeout=TIMEOUT_S)
            got[rank] = (peak, losses)
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: v[1] for r, v in got.items() if v[0] == "error"}
    if len(got) < world or errors:
        raise RuntimeError(f"mesh {shape}: {world - len(got)} ranks "
                           f"returned nothing; errors {errors}")
    return {"mesh": "x".join(map(str, shape)),
            "predicted_bytes": est["memory"]["peak_bytes"],
            "argument_bytes": est["memory"]["argument_bytes"],
            "peak_top": est["memory"]["peak_top"],
            "trace_s": est["trace_s"],
            "measured_bytes": [got[r][0] for r in range(world)],
            "losses": [got[r][1] for r in range(world)]}


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    meshes = args.mesh or ["2x2"]
    cfg = config(args)
    if args.device == "cuda":
        from repro_torch.kernels import _lib

        _lib.build()   # once, before the ranks look for it
    print(f"peak check: {cfg.name} ({cfg.n_layers} layers), "
          f"{args.batch} x {args.seq}, {args.steps} steps, remat, donating",
          flush=True)
    records, bad = [], []
    for spec in meshes:
        shape = tuple(int(x) for x in spec.split("x"))
        rec = run_mesh(args, cfg, shape)
        records.append(rec)
        pred = rec["predicted_bytes"]
        for rank, (meas, losses) in enumerate(zip(rec["measured_bytes"],
                                                  rec["losses"])):
            ratio = None if meas is None else pred / meas
            if ratio is not None and not 1 / RATIO <= ratio <= RATIO:
                bad.append((spec, rank, ratio))
            shown = "not measured" if meas is None else \
                f"{meas / 2**30:.3f} GiB, ratio {ratio:.3f}"
            print(f"  mesh {spec} rank {rank}: measured {shown}; "
                  f"losses {losses}", flush=True)
        print(f"  mesh {spec}: predicted {pred / 2**30:.3f} GiB "
              f"(arguments {rec['argument_bytes'] / 2**30:.3f}; traced in "
              f"{rec['trace_s']} s); largest live at the tracker's peak:",
              flush=True)
        for nbytes, label in rec["peak_top"]:
            print(f"    {nbytes / 2**30:8.3f} GiB  {label}", flush=True)
    print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers,
                      "batch": args.batch, "seq": args.seq,
                      "meshes": [{k: v for k, v in r.items()
                                  if k != "peak_top"} for r in records]}),
          flush=True)
    if bad:
        print(f"estimate off by more than {RATIO}x: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
