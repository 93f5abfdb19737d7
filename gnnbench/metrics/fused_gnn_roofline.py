"""fused_gnn_roofline (kernels): Σ bound / Σ device time over the traced
window's ``fused_gnn`` launches, in %. Each forward of the two-layer GCN
launches the kernel once a layer, layer 0 first; a launch's bound is its
layer's (``counts/gcn.py``) at the chip's peaks. The trace's launches
must be the window's launches as the kernel library counted them, two a
forward (a cache miss); otherwise nothing is read."""
from gnnbench.counts import gcn


def read(run):
    tr, peaks = run.trace, run.peaks
    if tr is None or peaks is None:
        return None
    _, dur = tr.ops("fused_gnn")
    launched = run.delta("launches", "fused_gnn")
    forwards = run.delta("engine", "logits_cache_misses")
    layers = gcn.network_layers(run.num_nodes, run.nnz, run.dims)
    if not len(dur) or len(dur) != launched or \
            launched != len(layers) * forwards:
        return None
    bound = forwards * sum(gcn.layer_bound_s(*layer, peaks)
                           for layer in layers)
    return 100.0 * bound / float(dur.sum())
