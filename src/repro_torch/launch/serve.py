"""GNN serving launcher: the Server over a GNNServeEngine, on the card.

Requests go in as tickets with optional priority/deadline, micro-batches
form under the hybrid max-batch-size + max-wait policy, and outcomes come
back typed (Completed / Rejected / Expired / Failed) with per-request
queue and engine latency::

    PYTHONPATH=src python -m repro_torch.launch.serve --graphs pubmed \
        --models gcn,sage_mean,sage_max

``--device cpu`` runs the plain PyTorch versions instead (for a quick
check on a machine without a card; use a small ``--scale``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import DATASETS, make_dataset
from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                 Rejected, SchedulerConfig, Server)


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
    engine = GNNServeEngine(device=args.device, max_shard_n=args.shard_n,
                            backend=args.backend)
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


def drive(engine: GNNServeEngine, datasets: dict, models: list[str],
          args) -> tuple[Server, list]:
    """Submit ``args.num_requests`` random node batches through a Server
    and drain it; returns the server and the outcomes in order."""
    server = Server(engine, SchedulerConfig(
        max_batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        max_queue_depth=args.queue_depth))
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="pubmed")
    ap.add_argument("--models", default="gcn,sage_mean,sage_max")
    ap.add_argument("--backend", default=None, choices=["cuda", "reference"],
                    help="kernel backend pinned into each Executable "
                         "(default: cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--shard-n", type=int, default=512)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--num-requests", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=4,
                    help="scheduler max micro-batch size")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="oldest-entry wait that dispatches an underfull "
                         "batch (0 = dispatch immediately)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-stream admission bound (backpressure)")
    ap.add_argument("--nodes-per-req", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; queued past it -> Expired")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
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
    pct = latency_percentiles(outcomes)
    if pct is not None:
        print(f"latency p50 {pct[0]:.2f} ms, p95 {pct[1]:.2f} ms, "
              f"p99 {pct[2]:.2f} ms")
    print(f"served {len(done)}/{len(outcomes)} requests in {dt:.2f}s "
          f"on {engine.device}")


if __name__ == "__main__":
    main()
