"""kernel_ms: the device time a refresh costs: the device time of every
kernel that ran in the window (no copy, no memset), over the refreshes
completed in it, in ms. Read from the device trace, which the driver
takes over the window of every run of a cell that reports this metric,
``--trace 0`` runs included. Host time is not in it: where the host's
work sets the refresh time, ``refresh_ms`` reads that beside it."""


def read(run):
    tr = run.trace
    done = sum(r.outcome == "completed" for r in run.refreshes)
    if tr is None or not done:
        return None
    kernel_s = tr.kernel_s()
    if kernel_s <= 0:
        return None
    return kernel_s / done * 1e3
