"""Kernel launches of one zoo forward, shared by the card tests.

One forward at 2 layers (gat 2 heads) on the cuda backend: gcn 2 fused
layers; sage_mean 2 shard_spmm + 2 dense; sage_max 4 dense (pool and
concat per layer) + 2 gathers; gin per layer 1 shard_spmm + 2 dense (its
MLP); gat 1 dense (z = h W) per layer and 1 shard_spmm per head: 2 heads
on layer 0, 1 on layer 1. ``chip_smoke.py`` states the same counts for
its own phases.
"""
FORWARD_LAUNCHES = {
    "gcn": {"fused_gnn": 2},
    "sage_mean": {"shard_spmm": 2, "dense_engine": 2},
    "sage_max": {"dense_engine": 4, "seg_gather": 2},
    "gin": {"shard_spmm": 2, "dense_engine": 4},
    "gat": {"shard_spmm": 3, "dense_engine": 2},
}

# one forward of the paper's Table-III networks (repro_torch.core.models,
# hidden 16, one hidden layer: two layers in all): gcn 2 fused layers
# (graph_first, fuse=True); graphsage 2 shard_spmm + 2 dense (the concat
# product); graphsage_pool 4 dense (pool and concat per layer) + 2
# gathers
PAPER_FORWARD_LAUNCHES = {
    "gcn": {"fused_gnn": 2},
    "graphsage": {"shard_spmm": 2, "dense_engine": 2},
    "graphsage_pool": {"dense_engine": 4, "seg_gather": 2},
}
