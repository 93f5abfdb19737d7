"""Streaming-graph launcher: mutate-while-serving + train-while-serve.

The port of ``repro.launch.stream``. Drives the whole
:mod:`repro_torch.stream` loop on one graph/model pair: a
continuous-batching :class:`repro_torch.serving.api.Server` answers node
requests while :func:`repro_torch.stream.random_delta` mutations land
through ``Server.mutate`` (incremental shard patching + targeted
invalidation) and a :class:`repro_torch.stream.StreamTrainer` fine-tunes
on the mutated neighborhoods every ``--finetune-every`` mutations,
hot-reloading the weights through ``Server.reload``.

On the card, through the hand-written kernels::

    PYTHONPATH=src python -m repro_torch.launch.stream --graph pubmed \
        --scale 1.0 --mutations 50

On the CPU (the kernels' plain versions; keep ``--scale`` small)::

    PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
        --scale 0.1 --steps 4 --mutations 10 --finetune-every 5

``--mesh N --model-parallel M`` serves sharded Executables on a (data,
model) mesh of N ranks in this process (gcn, sage_mean, gin; the
contiguous placement); the StreamTrainer fine-tunes its own
single-device mini-batch unit and reloads the weights into them.

``REPRO_LOCKSAN=1`` instruments every lock the stack creates
(:mod:`repro_torch.analyze.lock_sanitizer`): an acquisition-order cycle
(LS001) fails the run, long holds (LS002, threshold
``REPRO_LOCKSAN_HOLD_MS``) are reported::

    REPRO_LOCKSAN=1 PYTHONPATH=src python -m repro_torch.launch.stream \
        --device cpu --scale 0.1 --steps 4 --mutations 10 --finetune-every 5
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def run(args) -> dict:
    from repro_torch.analyze import lock_sanitizer
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.runtime.api import resolve_device
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
    from repro_torch.stream import StreamTrainer, random_delta

    device = resolve_device(args.device)
    # REPRO_LOCKSAN=1 instruments every lock the stack creates below:
    # the streaming loop doubles as the sanitizer's workload
    san = lock_sanitizer.current()
    if san is not None:
        print(f"[stream] lock sanitizer active "
              f"(hold threshold {san.hold_ms:.0f} ms)")
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import mesh_from_cli

        mesh = mesh_from_cli(args.mesh, args.model_parallel, device)
    rng = np.random.default_rng(args.seed)
    data = make_dataset(args.graph, scale=args.scale, seed=args.seed)
    prof = data.profile
    print(f"[stream] {args.graph}: {prof.num_nodes} nodes "
          f"{prof.num_edges} edges (scale={args.scale}) on {device}")

    spec = ZooSpec(args.arch, prof.feature_dim, args.hidden,
                   prof.num_classes, num_layers=args.layers,
                   heads=args.heads)
    engine = GNNServeEngine(device=device, backend=args.backend, mesh=mesh,
                            max_shard_n=args.shard_n, streaming=True,
                            edge_slack=args.edge_slack,
                            invalidation=args.invalidation)
    engine.register_graph(args.graph, data)
    engine.register_model(args.arch, spec)
    server = Server(engine, SchedulerConfig(max_batch_size=args.batch_size))
    trainer = StreamTrainer(server, graph=args.graph, model=args.arch,
                            batch_nodes=args.batch_nodes,
                            fanout=tuple(args.fanout),
                            steps_per_round=args.steps, lr=args.lr,
                            seed=args.seed)

    t_start = time.perf_counter()
    tickets = []
    for m in range(args.mutations):
        # traffic between mutations: the server must keep answering
        for _ in range(args.requests_per_mutation):
            ids = rng.integers(
                0, engine.graph_data(args.graph).profile.num_nodes,
                size=args.nodes_per_req)
            tickets.append(server.submit(
                NodeRequest(args.graph, ids, model=args.arch)))
        server.drain()

        delta = random_delta(data, rng, edge_ops=args.edge_ops,
                             p_node=args.p_node)
        rep = server.mutate(args.graph, delta)
        if args.verbose:
            print(f"[stream] mutation {m}: {delta.summary()} -> "
                  f"{rep['mutate_ms']:.1f} ms, {rep['executables']}")
        if (m + 1) % args.finetune_every == 0:
            trainer.round()

    server.drain()
    outcomes = [t.result() for t in tickets]
    served = sum(isinstance(o, Completed) for o in outcomes)
    wall_s = time.perf_counter() - t_start

    final_acc = trainer.train_accuracy()
    s = engine.stats
    print(f"[stream] {args.mutations} mutations, {served}/{len(tickets)} "
          f"requests completed in {wall_s:.1f}s")
    print(f"[stream] invalidation: {s['targeted_invalidations']} targeted "
          f"/ {s['full_invalidations']} full, "
          f"{s['nodes_invalidated']} rows dropped, "
          f"{s['graph_recompiles']} recompiles, "
          f"{s['graph_patches']} patches "
          f"({s['graph_patch_rebuilds']} rebuilds)")
    print(f"[stream] trainer: {trainer.stats['rounds']} rounds "
          f"({trainer.stats['steps']} steps, "
          f"{trainer.stats['reloads']} hot reloads, "
          f"{trainer.stats['rebuilds']} rebuilds), "
          f"final train acc {final_acc:.3f}")
    print("[stream] " + engine.cache_report())

    ok = served == len(tickets) and served > 0
    # with no compaction every round must reuse the trainer's one unit
    if s["graph_patch_rebuilds"] == 0 and trainer.stats["rebuilds"]:
        print(f"[stream] WARNING: the trainer rebuilt "
              f"{trainer.stats['rebuilds']}x with no compaction")
        ok = False
    lock_findings = []
    if san is not None:
        rep = san.report()
        lock_findings = [f.to_json() for f in rep.findings]
        if rep.findings:
            print(f"[stream] lock sanitizer:\n{rep.render()}")
        else:
            print(f"[stream] lock sanitizer: clean "
                  f"({san.acquisitions} acquisitions)")
        if rep.failed("error"):   # LS001 order cycle = deadlock hazard
            ok = False
    print(f"[stream] {'OK' if ok else 'FAILED'}")
    return {"ok": ok, "served": served, "submitted": len(tickets),
            "final_train_acc": final_acc, "engine_stats": dict(s),
            "trainer_stats": dict(trainer.stats), "wall_s": wall_s,
            "lock_findings": lock_findings}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="cora")
    ap.add_argument("--arch", default="gcn")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="dataset scale factor (1.0 = full profile)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--backend", default=None, choices=["cuda", "reference"],
                    help="kernel backend (default: cuda)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--shard-n", type=int, default=512)
    ap.add_argument("--mesh", type=int, default=0, metavar="RANKS",
                    help="serve on a (data, model) mesh of this many ranks "
                         "in this process (0 = single device)")
    ap.add_argument("--model-parallel", type=int, default=2,
                    help="model-axis size of the --mesh")
    ap.add_argument("--batch-size", type=int, default=8)
    # mutation workload
    ap.add_argument("--mutations", type=int, default=50,
                    help="number of GraphDelta bursts to apply")
    ap.add_argument("--edge-ops", type=int, default=8,
                    help="edge insert/delete ops per delta")
    ap.add_argument("--p-node", type=float, default=0.1,
                    help="probability a delta also adds a node")
    ap.add_argument("--requests-per-mutation", type=int, default=4)
    ap.add_argument("--nodes-per-req", type=int, default=8)
    ap.add_argument("--edge-slack", type=float, default=0.25,
                    help="slack-slot fraction of the edge-list template")
    ap.add_argument("--invalidation", choices=["targeted", "full"],
                    default="targeted")
    # fine-tune cadence
    ap.add_argument("--steps", type=int, default=20,
                    help="optimizer steps per fine-tune round")
    ap.add_argument("--finetune-every", type=int, default=10,
                    help="fine-tune round every this many mutations")
    ap.add_argument("--batch-nodes", type=int, default=32)
    ap.add_argument("--fanout", type=int, nargs="+", default=[5, 5])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None) -> None:
    out = run(parser().parse_args(argv))
    raise SystemExit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
