"""Reductions the metrics' readers share: the refresh time from the
driver's records, and shares of the device trace."""
from __future__ import annotations


def idle_share(run) -> float | None:
    """% of the traced window with no operation on the device."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def refresh_ms(run) -> float | None:
    """The window over the refreshes completed in it, in ms."""
    done = [r for r in run.refreshes if r.outcome == "completed"]
    if not done:
        return None
    return (done[-1].t_done - run.t_open) / len(done) * 1e3
