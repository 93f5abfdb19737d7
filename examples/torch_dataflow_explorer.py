"""Dataflow explorer (PyTorch port): the paper's Algorithm-1 schedule,
Table-I costs and the platform model, ending with what
``runtime.compile`` actually picks for a zoo model on this graph.

    PYTHONPATH=src python examples/torch_dataflow_explorer.py \
        --dataset pubmed --block 64 --budget-mb 24 [--device cpu]

Everything up to the compiled plan is host arithmetic (numpy); the
compile places the graph on the CUDA card unless ``--device cpu`` asks
for the CPU.
"""
import argparse
import sys

from repro_torch import runtime
from repro_torch.core.dataflow import (Dataflow, best_order,
                                       blocked_vs_conventional,
                                       simulate_traffic, table1_costs)
from repro_torch.core.perf_model import (GNNERATOR, GNNERATOR_NOBLOCK,
                                         GPU_2080TI, HYGCN, model_time)
from repro_torch.core.sharding import max_shard_nodes_for_budget, shard_graph
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--budget-mb", type=float, default=24.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the compiled plan: cuda or cpu")
    args = ap.parse_args(argv)

    ds = make_dataset(args.dataset)
    d = ds.profile.feature_dim
    budget = int(args.budget_mb * 2 ** 20)

    print(f"=== {ds.profile.name}: N={ds.profile.num_nodes} "
          f"E={ds.edges.shape[0]} D={d} ===\n")

    cmp = blocked_vs_conventional(num_nodes=ds.profile.num_nodes, D=d,
                                  B=args.block, onchip_bytes=budget)
    print(f"conventional dataflow: n={cmp['n_conventional']} nodes/shard "
          f"-> S={cmp['S_conventional']}")
    print(f"dimension-blocked (B={args.block}): n={cmp['n_blocked']} "
          f"-> S={cmp['S_blocked']}")
    print(f"off-chip traffic ratio (conv/blocked): "
          f"{cmp['traffic_ratio']:.2f}x\n")

    n = max_shard_nodes_for_budget(budget, args.block)
    sg = shard_graph(ds.edges, ds.profile.num_nodes, n)
    print(f"actual sharding: {sg.S}x{sg.S} grid, occupied-block density "
          f"{sg.density:.4f}")
    print(f"best traversal order (Table I): {best_order(sg.S)}")
    for order in ("dst_stationary", "src_stationary"):
        tr = simulate_traffic(Dataflow(S=sg.S, D=d, B=args.block, order=order),
                              nodes_per_shard=n, edges_per_shard=sg.occupancy)
        print(f"  {order:16s}: {tr.offchip_bytes / 2**20:8.1f} MiB off-chip, "
              f"{tr.onchip_edge_reads / 1e6:6.2f}M edge walks")
    print(f"  Table-I (S={sg.S}): {table1_costs(sg.S)}\n")

    print("platform model (GCN, end-to-end):")
    for p in (GPU_2080TI, HYGCN, GNNERATOR_NOBLOCK, GNNERATOR):
        t = model_time(p, "gcn", args.dataset, block_b=args.block)
        print(f"  {p.name:18s}: {t * 1e3:8.3f} ms")

    # what the runtime's compile step actually schedules for this graph
    # (quarter-scale copy: compiling densifies shard blocks on the device,
    # and the explorer only needs to show the plan, not pay full-graph
    # memory)
    demo = make_dataset(args.dataset, scale=0.25)
    spec = ZooSpec("gcn", demo.profile.feature_dim, 16,
                   demo.profile.num_classes, num_layers=2)
    exe = runtime.compile(spec, demo, device=args.device)
    print("\nruntime.compile plan (2-layer GCN, scale=0.25):")
    print(exe.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
