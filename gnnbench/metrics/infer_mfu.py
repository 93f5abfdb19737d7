"""infer_mfu (whole step): the whole refresh's counted work, every layer
of the network (``counts/<arch>.py`` of the run's architecture, the last
layer writing the logits the softmax reads) at the chip's peaks, over the
refresh's wall time in the traced run, in %. The count describes the
network's work, not its kernels, so it bounds any kernel's share. A new
architecture brings its ``counts/<arch>.py`` with ``network_bound_s``
and adds its cells to this metric's ``workloads``."""
import pathlib

from gnnbench.harness import spec
from gnnbench.harness.reduce import refresh_ms

COUNTS = pathlib.Path(__file__).resolve().parent.parent / "counts"


def read(run):
    ms = refresh_ms(run)
    if ms is None or run.peaks is None or run.trace is None:
        return None
    arch = run.config["arch"]
    counts = spec.load_module(COUNTS / f"{arch}.py", f"gnnbench_counts_{arch}")
    bound = counts.network_bound_s(run.num_nodes, run.nnz, run.dims,
                                   run.peaks)
    return 100.0 * bound / (ms / 1e3)
