"""forward_host_ms (runtime): the host time to enqueue a refresh's
forward (Python, the plan, the kernels' launches; no wait for the
device), in ms: the program's ``runtime.forward`` spans in the traced
window over the refreshes completed in it."""
from gnnbench.harness import spans


def read(run):
    return spans.per_refresh_ms(run, "runtime.forward")
