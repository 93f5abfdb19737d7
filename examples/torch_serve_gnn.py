"""Serve GNN node-classification requests through the async Server API
(PyTorch port).

Runs a 2-layer GCN and a 2-layer GAT from the repro_torch.gnn model zoo
behind the continuous-batching :class:`repro_torch.serving.Server`. Each
(model, graph) pair is compiled once via ``repro_torch.runtime`` — the
planner picks (S, B, order, fused) per layer from the Table-I cost model,
the runtime GraphStore shards + caches the graph once per normalization
signature — and node-id requests go in as tickets (with priorities),
micro-batch per (model, graph) stream, and come back as typed outcomes
with per-request queue/engine latency.

    PYTHONPATH=src python examples/torch_serve_gnn.py [--scale 1.0] \
        [--requests 32] [--device cpu]

It serves on the CUDA card through the hand-written kernels unless
``--device cpu`` asks for the CPU (the kernels' plain PyTorch versions).
"""
import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora",
                    choices=["cora", "citeseer", "pubmed"])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="graph scale factor (1.0 = full Table-II profile)")
    ap.add_argument("--backend", default=None,
                    choices=["cuda", "reference", "ref"],
                    help="kernel backend (default: REPRO_KERNEL_BACKEND "
                         "env var, else cuda — the hand-written kernels)")
    ap.add_argument("--requests", "--num-requests", dest="requests",
                    type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="scheduler max micro-batch size")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    backend = (args.backend or os.environ.get("REPRO_KERNEL_BACKEND")
               or "cuda")

    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                     SchedulerConfig, Server)

    ds = make_dataset(args.dataset, seed=0, scale=args.scale)
    prof = ds.profile
    print(f"{prof.name}: {prof.num_nodes} nodes, {ds.edges.shape[0]} edges, "
          f"{prof.feature_dim} features, {prof.num_classes} classes")

    engine = GNNServeEngine(device=args.device, max_shard_n=512,
                            backend=backend)
    engine.register_graph(args.dataset, ds)
    engine.register_model("gcn-2l", ZooSpec("gcn", prof.feature_dim,
                                            args.hidden, prof.num_classes,
                                            num_layers=2))
    engine.register_model("gat-2l", ZooSpec("gat", prof.feature_dim,
                                            args.hidden, prof.num_classes,
                                            num_layers=2, heads=2))

    # show what each (model, graph) pair compiled to
    for name in ("gcn-2l", "gat-2l"):
        print("\n" + engine.executable(name, args.dataset).summary())

    server = Server(engine, SchedulerConfig(max_batch_size=args.batch_size))

    rng = np.random.default_rng(7)
    t0 = time.time()
    tickets = []
    for i in range(args.requests):
        ids = rng.integers(0, prof.num_nodes,
                           size=int(rng.integers(1, 9)))
        tickets.append(server.submit(
            NodeRequest(args.dataset, ids,
                        model="gcn-2l" if i % 2 else "gat-2l"),
            priority=1 if i % 8 == 0 else 0))
    # submit() is non-blocking: tickets are pending until the scheduler runs
    assert tickets[0].poll() is None
    server.drain()
    dt = time.time() - t0

    outcomes = [t.result() for t in tickets]
    done = [o for o in outcomes if isinstance(o, Completed)]
    print(f"\nserved {len(done)} requests in {dt:.2f}s "
          f"({len(done) / dt:.1f} req/s); per-request predictions:")
    for o in done[:6]:
        p = o.value
        print(f"  {p.model}: nodes {p.node_ids.tolist()} -> "
              f"classes {p.classes.tolist()} "
              f"(queue {o.queue_ms:.2f} ms, engine {o.engine_ms:.2f} ms)")
    if len(done) > 6:
        print(f"  ... ({len(done) - 6} more)")
    print("\n" + engine.cache_report())
    print(server.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
