"""handoff_ms (server): a refresh request's wait from its admission in
``Server.submit`` to its dispatch on the server's thread (the thread's
wake-up and the batch's formation), in ms: the program's ``server.queue``
spans in the traced window over the refreshes completed in it."""
from gnnbench.harness import spans

spans.install()


def read(run):
    return spans.per_refresh_ms(run, "server.queue")
