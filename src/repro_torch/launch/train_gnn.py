"""GNN training launcher (``runtime.fit`` end to end), the port's.

Full-batch on the card, through the hand-written kernels::

    PYTHONPATH=src python -m repro_torch.launch.train_gnn \
        --dataset pubmed --arch gcn --steps 20

Neighbor-sampled mini-batches::

    PYTHONPATH=src python -m repro_torch.launch.train_gnn \
        --dataset citeseer --arch sage_mean --steps 100 \
        --batch-nodes 256 --fanout 10,5

On the CPU (the plain PyTorch versions; keep ``--scale`` small)::

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \
        --dataset cora --arch gcn --steps 4 --scale 0.25

Data-parallel over a (data, model) mesh of ``--mesh`` ranks in one
process on the card (full-batch; the replicated parameters' gradients
are all-reduced over the mesh; ``--verify-comm`` checks the train step's
counted collectives)::

    PYTHONPATH=src python -m repro_torch.launch.train_gnn \
        --dataset pubmed --arch gcn --steps 20 --mesh 8 \
        --model-parallel 2 --verify-comm

``--ckpt-dir`` makes the run resumable: interrupt it, rerun the same
command, and it continues from the latest checkpoint to ``--steps``.
``--plan autotune`` trains with the plan the autotuner measured fastest
on the device (``--tune-budget`` candidates at most; not on a mesh).
"""
from __future__ import annotations

import argparse
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--arch", default="gcn")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset node/edge scale factor")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--backend", default=None, choices=["cuda", "reference"])
    ap.add_argument("--plan", choices=["analytic", "autotune"],
                    default="analytic",
                    help="layer-plan source: the Table-I cost model, or "
                         "the plan the autotuner measured fastest")
    ap.add_argument("--tune-budget", type=int, default=8,
                    help="--plan autotune: max candidate plans measured")
    ap.add_argument("--shard-n", type=int, default=512)
    ap.add_argument("--batch-nodes", type=int, default=0,
                    help="0 trains full-batch; >0 neighbor-samples this "
                         "many seed nodes per step")
    ap.add_argument("--fanout", default="10,5",
                    help="comma per-layer neighbor sample counts")
    ap.add_argument("--mesh", type=int, default=0, metavar="RANKS",
                    help="data-parallel full-batch training on a (data, "
                         "model) mesh of this many ranks in this process")
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--partition", choices=["contiguous", "fennel"],
                    default="contiguous",
                    help="--mesh data-axis placement: contiguous dst-row "
                         "ranges, or the fennel locality partitioner + "
                         "replicated hub-feature cache")
    ap.add_argument("--hub-cache", type=int, default=256,
                    help="--partition fennel: replicated hub vertices")
    ap.add_argument("--verify-comm", action="store_true",
                    help="--mesh: check the train step's collectives")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory (resumable runs)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save-params", default=None,
                    help="write the trained weights to this .npz (loadable "
                         "via Executable.load_params for a serving reload)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset

    dev = runtime.resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import mesh_from_cli

        mesh = mesh_from_cli(args.mesh, args.model_parallel, dev)
        print(f"mesh: data={args.mesh // args.model_parallel} x "
              f"model={args.model_parallel} on {dev}")

    ds = make_dataset(args.dataset, seed=0, scale=args.scale)
    print(f"{ds.profile.name}: {ds.profile.num_nodes} nodes, "
          f"{ds.edges.shape[0]} edges, {ds.profile.feature_dim} features, "
          f"{int(ds.train_mask.sum())} train nodes; device {dev}")
    spec = ZooSpec(args.arch, ds.profile.feature_dim, args.hidden,
                   ds.profile.num_classes, num_layers=args.layers)

    fanout = tuple(int(f) for f in args.fanout.split(",") if f)
    t0 = time.time()
    result = runtime.fit(
        spec, ds, steps=args.steps, lr=args.lr,
        weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_steps=max(0, args.steps // 20) if args.schedule != "constant"
        else 0,
        batch_nodes=args.batch_nodes, fanout=fanout, device=dev,
        backend=args.backend, mesh=mesh, partition=args.partition,
        hub_cache=args.hub_cache, max_shard_n=args.shard_n, plan=args.plan,
        tune_budget=args.tune_budget, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_every=args.log_every)
    dt = time.time() - t0

    print(result.executable.summary())
    regime = (f"mini-batch({args.batch_nodes} seeds, fanout {fanout})"
              if args.batch_nodes else "full-batch")
    steps_run = len(result.history) and result.history[-1][0] + 1
    print(f"trained {args.arch} on {ds.profile.name} [{regime}] "
          f"{steps_run}/{args.steps} steps in {dt:.1f}s; "
          f"train accuracy {result.train_accuracy():.3f}")

    if mesh is not None and args.verify_comm:
        cs = result.trainable.verify_train_comm()
        wire = cs["measured_wire_bytes"]
        print("train-step collectives (wire bytes): "
              + ", ".join(f"{k}={v:.3g}" for k, v in sorted(wire.items())))
        print(f"forward all-gather model: "
              f"{cs['forward_allgather_wire_bytes']:.3g} B "
              f"(counted all-gather >= model: verified)")

    if args.save_params:
        result.executable.save_params(args.save_params)
        print(f"saved trained params to {args.save_params}")


if __name__ == "__main__":
    main()
