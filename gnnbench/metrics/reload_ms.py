"""reload_ms (engine): the weight push's host time a refresh, in ms: the
program's ``server.reload`` spans in the traced window (the wait for the
step lock, then ``GNNServeEngine.reload_params``) over the refreshes
completed in it."""
from gnnbench.harness import spans


def read(run):
    return spans.per_refresh_ms(run, "server.reload")
