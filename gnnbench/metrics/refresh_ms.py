"""refresh_ms (whole step): the time to fresh predictions for every node
after a weight push, read in a traced run: the closed loop's window,
from its opening to the last refresh's answer, over the refreshes
completed in it, in ms. It was the end-to-end ``infer_ms``; the host's
numpy work on the logits sets it, and the host's speed varies from
process to process by more than a bound can hold, so it is read per
layer beside ``kernel_ms``."""
from gnnbench.harness.reduce import refresh_ms


def read(run):
    return refresh_ms(run)
