"""idle_share.infer (device): the share of the traced window, in %, in
which no kernel, copy or memset ran on the device, in the refresh
cells."""
from gnnbench.harness.reduce import idle_share


def read(run):
    return idle_share(run)
