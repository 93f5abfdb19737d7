"""Serving launcher: one Server path for both engines, on the card.

Requests go in as tickets with optional priority/deadline, micro-batches
form under the hybrid max-batch-size + max-wait policy, and outcomes come
back typed (Completed / Rejected / Expired / Failed) with per-request
queue and engine latency. The LM ``ServeEngine`` streams by prompt
length, the ``GNNServeEngine`` by (model, graph).

LM generation (default; ``--smoke`` is on by default, ``--no-smoke``
serves the full-width model with random weights)::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch qwen3-8b --no-smoke --num-requests 8 --prompt-len 1024 \
        --new-tokens 16

GNN node classification::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gnn \
        --graphs pubmed --models gcn,sage_mean,sage_max,gin,gat

``--plan autotune`` compiles each (model, graph) pair with the plan the
autotuner measured fastest on the device (``--tune-budget`` candidates
at most; winners memoized in ``REPRO_PLAN_CACHE`` when it is set).

``--device cpu`` runs the plain PyTorch versions instead (for a quick
check on a machine without a card; use ``--smoke`` LMs and a small
``--scale``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import DATASETS, make_dataset
from repro_torch.models import lm
from repro_torch.runtime.api import resolve_device
from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                 Rejected, Request, SchedulerConfig,
                                 ServeEngine, Server)


def _submit(server: Server, payload, stats: dict, **kw):
    """Closed-loop submit: on queue-full backpressure, drive the scheduler
    to make room and retry instead of dropping the request."""
    while True:
        ticket = server.submit(payload, **kw)
        out = ticket.poll()
        if not (isinstance(out, Rejected) and out.kind == "backpressure"):
            return ticket
        if server.step(force=True) == 0:
            return ticket           # no progress possible; keep the reject
        stats["retries"] = stats.get("retries", 0) + 1


def latency_percentiles(outcomes) -> tuple[float, float, float] | None:
    """(p50, p95, p99) request latency in ms over Completed outcomes."""
    lat = [o.latency_ms for o in outcomes if isinstance(o, Completed)]
    if not lat:
        return None
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return float(p50), float(p95), float(p99)


def build_engine(args) -> tuple[GNNServeEngine, dict]:
    """Engine with every (graph, model) pair registered as ``model@graph``."""
    graphs = [g.strip() for g in args.graphs.split(",") if g.strip()]
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    if args.plan == "autotune":
        print(f"plan source: autotune (budget {args.tune_budget} candidates "
              f"per (model, graph); winners memoized via REPRO_PLAN_CACHE)")
    engine = GNNServeEngine(device=args.device, max_shard_n=args.shard_n,
                            backend=args.backend, plan=args.plan,
                            tune_budget=args.tune_budget)
    datasets = {}
    for g in graphs:
        est_nodes = int(DATASETS[g].num_nodes * args.scale)
        if est_nodes ** 2 * 4 > engine.max_dense_gib * 2 ** 30:
            raise SystemExit(
                f"graph {g!r} at scale {args.scale} (~{est_nodes} nodes) "
                f"exceeds the {engine.max_dense_gib} GiB dense-shard limit; "
                f"pass a smaller --scale")
        ds = make_dataset(g, seed=0, scale=args.scale)
        datasets[g] = ds
        engine.register_graph(g, ds)
        print(f"graph {g}: {ds.profile.num_nodes} nodes, "
              f"{ds.edges.shape[0]} edges, {ds.profile.feature_dim} features")
        prof = ds.profile
        for m in models:
            engine.register_model(
                f"{m}@{g}",
                ZooSpec(m, prof.feature_dim, args.hidden, prof.num_classes,
                        num_layers=args.layers), seed=0)
    return engine, datasets


def make_server(engine, args) -> Server:
    return Server(engine, SchedulerConfig(
        max_batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        max_queue_depth=args.queue_depth))


def drive(engine: GNNServeEngine, datasets: dict, models: list[str],
          args) -> tuple[Server, list]:
    """Submit ``args.num_requests`` random node batches through a Server
    and drain it; returns the server and the outcomes in order."""
    server = make_server(engine, args)
    graphs = list(datasets)
    rng = np.random.default_rng(1)
    stats: dict = {}
    tickets = []
    for i in range(args.num_requests):
        g = graphs[int(rng.integers(len(graphs)))]
        m = models[int(rng.integers(len(models)))]
        n = datasets[g].profile.num_nodes
        ids = rng.integers(0, n, size=int(rng.integers(1, args.nodes_per_req + 1)))
        tickets.append(_submit(
            server, NodeRequest(graph=g, node_ids=ids, model=f"{m}@{g}"),
            stats, priority=1 if i % 8 == 0 else 0,
            deadline_ms=args.deadline_ms))
    server.drain()
    return server, [t.result() for t in tickets]


def build_lm_engine(args) -> ServeEngine:
    """A ServeEngine over ``args.arch`` (its smoke config unless
    ``--no-smoke``) with random weights drawn on the device from seed 0;
    max_len fits ``--prompt-len`` + ``--new-tokens``."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    params = lm.init_params(cfg, gen)
    return ServeEngine(cfg, params,
                       max_len=args.prompt_len + args.new_tokens + 1,
                       device=device, backend=args.backend)


def lm_requests(cfg, n: int, prompt_len: int, new_tokens: int,
                temperature: float = 0.0, seed: int = 0) -> list[Request]:
    """``n`` requests with random prompts of ``prompt_len`` tokens."""
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, prompt_len)
                    .astype(np.int32), max_new_tokens=new_tokens,
                    temperature=temperature) for _ in range(n)]


def drive_lm(engine: ServeEngine, requests: list[Request],
             args) -> tuple[Server, list]:
    """Submit ``requests`` through a Server and drain it; returns the
    server and the outcomes in order."""
    server = make_server(engine, args)
    stats: dict = {}
    tickets = [_submit(server, r, stats, deadline_ms=args.deadline_ms)
               for r in requests]
    server.drain()
    return server, [t.result() for t in tickets]


def lm_report(engine: ServeEngine) -> str:
    """Prefill ms per batch, decode ms per step and decode tok/s."""
    st = engine.stats
    pre = st["prefill_ms_total"] / max(st["prefill_batches"], 1)
    dec = st["decode_ms_total"] / max(st["decode_steps"], 1)
    tok_s = st["decode_tokens"] / max(st["decode_ms_total"], 1e-9) * 1e3
    return (f"prefill {st['prefill_batches']} batches, {pre:.3f} ms/batch "
            f"({st['prefill_tokens']} prompt tokens) | decode "
            f"{st['decode_steps']} steps, {dec:.3f} ms/step, {tok_s:.1f} "
            f"tok/s")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["lm", "gnn"], default="lm")
    ap.add_argument("--backend", default=None, choices=["cuda", "reference"],
                    help="kernel backend (default: cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--num-requests", type=int, default=8)
    # LM path
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the arch's smoke config (--no-smoke: full "
                         "width)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    # GNN path
    ap.add_argument("--graphs", default="pubmed")
    ap.add_argument("--models", default="gcn,sage_mean,sage_max",
                    help="comma list of zoo archs: gcn, sage_mean, "
                         "sage_max, gin, gat")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--plan", choices=["analytic", "autotune"],
                    default="analytic",
                    help="layer-plan source: Table-I cost model, or "
                         "measured winners from the repro_torch.tune "
                         "autotuner")
    ap.add_argument("--tune-budget", type=int, default=8,
                    help="--plan autotune: max candidate plans measured "
                         "per (model, graph)")
    ap.add_argument("--shard-n", type=int, default=512)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--nodes-per-req", type=int, default=8)
    # shared scheduler policy
    ap.add_argument("--batch-size", type=int, default=4,
                    help="scheduler max micro-batch size")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="oldest-entry wait that dispatches an underfull "
                         "batch (0 = dispatch immediately)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-stream admission bound (backpressure)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; queued past it -> Expired")
    return ap


def _serve_lm(args) -> None:
    engine = build_lm_engine(args)
    requests = lm_requests(engine.cfg, args.num_requests, args.prompt_len,
                           args.new_tokens, args.temperature)
    t0 = time.perf_counter()
    server, outcomes = drive_lm(engine, requests, args)
    dt = time.perf_counter() - t0
    done = [o.value for o in outcomes if isinstance(o, Completed)]
    served = sum(len(v) for v in done)
    print(server.report())
    _print_latency(outcomes)
    print(lm_report(engine))
    print(f"served {len(done)}/{len(outcomes)} requests, {served} tokens in "
          f"{dt:.2f}s ({served / dt:.1f} tok/s) with {engine.cfg.name} on "
          f"{engine.device}")


def _serve_gnn(args) -> None:
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    engine, datasets = build_engine(args)
    t0 = time.perf_counter()
    server, outcomes = drive(engine, datasets, models, args)
    dt = time.perf_counter() - t0
    done = [o.value for o in outcomes if isinstance(o, Completed)]
    for p in done[:4]:
        print(f"  {p.model} on {p.graph}: nodes {p.node_ids[:5].tolist()} -> "
              f"classes {p.classes[:5].tolist()} "
              f"(p={np.round(p.probs[:5], 3).tolist()})")
    print(engine.cache_report())
    print(server.report())
    _print_latency(outcomes)
    print(f"served {len(done)}/{len(outcomes)} requests in {dt:.2f}s "
          f"on {engine.device}")


def _print_latency(outcomes) -> None:
    pct = latency_percentiles(outcomes)
    if pct is not None:
        print(f"latency p50 {pct[0]:.2f} ms, p95 {pct[1]:.2f} ms, "
              f"p99 {pct[2]:.2f} ms")


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.mode == "gnn":
        _serve_gnn(args)
    else:
        _serve_lm(args)


if __name__ == "__main__":
    main()
