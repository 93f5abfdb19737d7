"""kernel_mfu (whole step): the whole refresh's counted work, every layer
of the network (``counts/<arch>.py`` of the run's architecture) at the
chip's peaks, over the device time of every kernel a refresh launched
(``kernel_ms``), in %. It bounds the share of any kernel that computes
the network, so a kernel taken off the path still shows here."""
import pathlib

from gnnbench.harness import spec

COUNTS = pathlib.Path(__file__).resolve().parent.parent / "counts"
KERNEL_MS = spec.load_module(pathlib.Path(__file__).with_name("kernel_ms.py"),
                             "gnnbench_metric_kernel_ms_of_kernel_mfu")


def read(run):
    ms = KERNEL_MS.read(run)
    if ms is None or run.peaks is None:
        return None
    arch = run.config["arch"]
    counts = spec.load_module(COUNTS / f"{arch}.py", f"gnnbench_counts_{arch}")
    bound = counts.network_bound_s(run.num_nodes, run.nnz, run.dims,
                                   run.peaks)
    return 100.0 * bound / (ms / 1e3)
