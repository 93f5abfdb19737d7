"""infer_mfu (whole step): the whole refresh's counted work, every layer
of the network (``counts/gcn.py``, the last one writing the logits the
softmax reads) at the chip's peaks, over the refresh's wall time in the
traced run, in %. The count describes the network's work, not its
kernels, so it bounds any kernel's share."""
from gnnbench.counts import gcn
from gnnbench.harness.reduce import refresh_ms


def read(run):
    ms = refresh_ms(run)
    if ms is None or run.peaks is None or run.trace is None:
        return None
    bound = gcn.network_bound_s(run.num_nodes, run.nnz, run.dims, run.peaks)
    return 100.0 * bound / (ms / 1e3)
