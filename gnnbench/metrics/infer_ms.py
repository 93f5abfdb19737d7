"""infer_ms: the time to fresh predictions for every node after a weight
push. The closed loop's window, from its opening to the last refresh's
answer, over the refreshes completed in it."""
from gnnbench.harness.reduce import refresh_ms


def read(run):
    return refresh_ms(run)
