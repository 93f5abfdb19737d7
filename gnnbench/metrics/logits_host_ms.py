"""logits_host_ms (runtime): the host's work on a refresh's logits after
their copy, in ms: the softmax of the full logits (``runtime.softmax``)
and the request's answer from it, gather, argmax and max
(``runtime.answer``), the program's spans in the traced window over the
refreshes completed in it."""
from gnnbench.harness import spans


def read(run):
    return spans.per_refresh_ms(run, "runtime.softmax", "runtime.answer")
