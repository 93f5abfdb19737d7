"""Quickstart (PyTorch port): train a zoo GNN on (synthetic) Cora through
the runtime.

One ``runtime.fit()`` call compiles the model (the planner picks feature
block size B, shard grid, traversal order, fused vs two-stage per layer),
runs the AdamW train step through the hand-written kernels — full-batch
by default, neighbor-sampled mini-batches with ``--batch-nodes`` — and
hands back the trained, servable Executable.

    PYTHONPATH=src python examples/torch_quickstart.py [--epochs 30] \
        [--dataset pubmed] [--batch-nodes 256] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU (the
kernels' plain PyTorch versions).
"""
import argparse
import sys
import time

import torch

from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset

# paper Table-III names -> zoo architectures
NETWORKS = {"gcn": "gcn", "graphsage": "sage_mean",
            "graphsage_pool": "sage_max"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora",
                    choices=["cora", "citeseer", "pubmed"])
    ap.add_argument("--network", default="gcn", choices=sorted(NETWORKS))
    ap.add_argument("--epochs", type=int, default=30,
                    help="full-batch steps (or mini-batch steps with "
                         "--batch-nodes)")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--shard-n", type=int, default=512,
                    help="planner cap on nodes per shard (the paper's n)")
    ap.add_argument("--batch-nodes", type=int, default=0,
                    help="0 = full-batch; >0 neighbor-samples this many "
                         "seed nodes per step")
    ap.add_argument("--backend", default=None,
                    choices=["cuda", "reference", "ref"],
                    help="kernel backend (default: REPRO_KERNEL_BACKEND "
                         "env, else cuda — the plain versions on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    args = ap.parse_args(argv)

    ds = make_dataset(args.dataset)
    print(f"{ds.profile.name}: {ds.profile.num_nodes} nodes, "
          f"{ds.edges.shape[0]} edges, {ds.profile.feature_dim} features "
          f"({ds.size_mb:.1f} MB)")

    spec = ZooSpec(NETWORKS[args.network], ds.profile.feature_dim,
                   args.hidden, ds.profile.num_classes, num_layers=2)
    t0 = time.time()
    result = runtime.fit(spec, ds, steps=args.epochs, lr=5e-3,
                         device=args.device, backend=args.backend,
                         max_shard_n=args.shard_n,
                         batch_nodes=args.batch_nodes, fanout=(10, 5),
                         log_every=max(1, args.epochs // 10))
    exe = result.executable               # trained weights already swapped in
    print(exe.summary())

    labels = torch.as_tensor(ds.labels, device=exe.device).long()
    test = torch.as_tensor(~ds.train_mask, device=exe.device)
    pred = exe.forward().argmax(-1)
    test_acc = (pred == labels)[test].float().mean().item()
    print(f"trained in {time.time() - t0:.1f}s: "
          f"train-acc {result.train_accuracy():.3f} test-acc {test_acc:.3f}")
    classes, probs = exe.predict([0, 1, 2])
    print(f"predict([0,1,2]) -> classes {classes.tolist()} "
          f"(p={[round(float(p), 3) for p in probs]})")
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
