"""repro_torch.runtime — the compile-style GNN execution API.

    from repro_torch import runtime
    exe = runtime.compile(spec, graph)              # on cuda
    exe = runtime.compile(spec, graph, plan="autotune")   # measured plan
    exe = runtime.compile(spec, graph,                    # per-op backends
                          op_backends={"gather_aggregate": "reference"})
    logits = exe.forward()                          # full graph
    classes, probs = exe.predict([0, 7, 9])         # cached softmax
    print(exe.summary())
    result = runtime.fit(spec, graph, steps=200)    # train, then serve
    result.executable.predict([0, 7, 9])
"""
from repro_torch.gnn.executor import clear_plan_cache, plan_cache_stats
from repro_torch.kernels.registry import (KernelBackend, get_backend,
                                          list_backends, register_backend)
from repro_torch.runtime.api import compile, graph_fingerprint, resolve_device
from repro_torch.runtime.cache import GraphStore, default_store
from repro_torch.runtime.executable import Executable
from repro_torch.runtime.fit import (FitResult, TrainableExecutable,
                                     masked_cross_entropy, fit)
from repro_torch.runtime.forward import forward
from repro_torch.tune import clear_tune_cache, tune_cache_stats

__all__ = ["compile", "graph_fingerprint", "resolve_device", "GraphStore",
           "default_store", "KernelBackend", "get_backend", "list_backends",
           "register_backend", "Executable", "FitResult", "TrainableExecutable",
           "masked_cross_entropy", "fit", "forward", "plan_cache_stats",
           "clear_plan_cache", "tune_cache_stats", "clear_tune_cache"]
