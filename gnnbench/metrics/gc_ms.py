"""gc_ms (host): Python's garbage collections in the traced window, on
any thread, over the refreshes completed in it, in ms (the program's
``python.gc.gen<n>`` spans)."""
from gnnbench.harness import spans

spans.install()


def read(run):
    return spans.per_refresh_ms(run, "python.gc")
