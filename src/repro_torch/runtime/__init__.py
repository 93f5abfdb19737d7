"""repro_torch.runtime — the compile-style GNN execution API.

    from repro_torch import runtime
    exe = runtime.compile(spec, graph)              # on cuda
    logits = exe.forward()                          # full graph
    classes, probs = exe.predict([0, 7, 9])         # cached softmax
    print(exe.summary())
"""
from repro_torch.runtime.api import compile, graph_fingerprint, resolve_device
from repro_torch.runtime.cache import GraphStore
from repro_torch.runtime.executable import Executable
from repro_torch.runtime.forward import forward

__all__ = ["compile", "graph_fingerprint", "resolve_device", "GraphStore",
           "Executable", "forward"]
