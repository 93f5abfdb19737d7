"""Build-stability + dtype passes over the port's forward.

The counterpart of the reference's ``repro.analyze.jaxpr_lint``, which
reads jit trace caches and walks jaxprs. Torch has neither, so each pass
watches what the port really does instead.

**Build stability (the retrace pass).** Torch keeps no jit cache, so
there is no trace to count. The first-use work a request pays in the
port is (1) the CSR index builds of a graph's ``GraphTensors``
(``gather_index`` / ``linear_index``, counted by
:func:`repro_torch.kernels.csr.index_builds`) and (2) compiles:
``runtime.compile`` calls and ``GraphStore`` builds (counted by
:func:`repro_torch.runtime.cache.compile_counts`). A warm entry point
must build and compile nothing. The static halves flag the causes
(Python-number parameters, RT002; ``torch.compile`` inside a loop,
``ast_lint.RT101``); the dynamic half (:func:`build_stability`, the port
of ``trace_stability``) is the oracle: drive the entry point and read
the counters (RT003). The counters are process-wide: probe without
concurrent traffic.

**Dtype pass.** One real forward under a ``TorchDispatchMode`` that
sees every aten op's input and output tensors (dtype, element count):

  * **DT001** (error)   — a float64 or complex128 value: it doubles every
    buffer it touches and runs at a fraction of the float32 rate. Code
    that means it says so with :func:`allow_f64` (the port's form of the
    reference's ``dtype_findings(allow_f64=)``);
  * **DT002** (warning) — an entry input (a parameter or the grouped
    features) that is not a float32 tensor;
  * **DT003** (warning) — a tensor of more than 2³¹−1 elements: a
    flattened int32 index over it (edge gathers, dense shard grids)
    wraps.

The forward must be real: the hand-written kernels launch through
ctypes with raw pointers, so fake or meta tensors cannot run them. The
dispatch mode sees the aten ops around a launch, not the launch.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analyze.report import Finding
from repro_torch.kernels import csr
from repro_torch.training.optimizer import tree_leaves

_INT32_MAX = 2 ** 31 - 1
_WIDE = (torch.float64, torch.complex128)
_tls = threading.local()


# --------------------------------------------------------------------------
# build stability (retrace)
# --------------------------------------------------------------------------

def _counts() -> tuple[dict, dict]:
    from repro_torch.runtime.cache import compile_counts
    return csr.index_builds(), compile_counts()


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def python_scalar_leaves(tree, *, name: str,
                         pass_name: str = "retrace") -> list[Finding]:
    """RT002: Python int/float/bool leaves in a parameter tree. The
    forward takes them as constants, not tensors: they are no parameter
    (no gradient, no checkpoint, no reload) and a typed value in their
    place changes every op they touch."""
    out: list[Finding] = []
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, (bool, int, float)) and \
                not isinstance(leaf, np.generic):
            out.append(Finding(
                rule="RT002", severity="warning", pass_name=pass_name,
                message=f"tree leaf {i} is a Python "
                        f"{type(leaf).__name__} ({leaf!r}); it enters the "
                        f"forward as a constant, not a parameter — make it "
                        f"a tensor with an explicit dtype",
                location=name))
    return out


def build_stability(fn, calls, *, name: str,
                    max_builds: int | None = None) -> list[Finding]:
    """RT003: drive ``fn`` with every args-tuple in ``calls`` and flag
    index builds beyond ``max_builds`` of each kind (None: as many as
    the first call built) or any compile — the dynamic oracle: a
    per-request rebuild surfaces here whatever its cause."""
    calls = list(calls)
    if not calls:
        return []
    idx0, cmp0 = _counts()
    fn(*calls[0])
    first = _diff(csr.index_builds(), idx0)
    for args in calls[1:]:
        fn(*args)
    idx1, cmp1 = _counts()
    built, compiled = _diff(idx1, idx0), _diff(cmp1, cmp0)
    allowed = first if max_builds is None else dict.fromkeys(built,
                                                             max_builds)
    if any(built[k] > allowed[k] for k in built) or any(compiled.values()):
        return [Finding(
            rule="RT003", severity="error", pass_name="retrace",
            message=f"{len(calls)} same-spec calls built index(es) "
                    f"{built} (expected <= {allowed}), made "
                    f"{compiled['compiles']} compile(s) and "
                    f"{compiled['graph_builds']} graph build(s); a "
                    f"per-request rebuild is hiding in this entry point",
            location=name)]
    return []


# --------------------------------------------------------------------------
# dtype drift
# --------------------------------------------------------------------------

@contextlib.contextmanager
def allow_f64(reason: str):
    """Scope in which float64/complex128 values are deliberate: DT001
    does not fire on ops dispatched inside it, on this thread. ``reason``
    says why, for the reader of the code."""
    if not reason:
        raise ValueError("allow_f64 needs a reason")
    prev = getattr(_tls, "f64", None)
    _tls.f64 = reason
    try:
        yield
    finally:
        _tls.f64 = prev


def _f64_allowed() -> bool:
    return getattr(_tls, "f64", None) is not None


class _DtypeRecorder(TorchDispatchMode):
    """Notes, per aten op, the first unscoped float64/complex128 tensor
    and the first tensor past int32 element count among its inputs and
    outputs."""

    def __init__(self):
        super().__init__()
        self.wide: dict[str, torch.dtype] = {}
        self.big: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = str(func.overloadpacket)
        allowed = _f64_allowed()
        for t in tree_leaves((args, kwargs or {}, out)):
            if not isinstance(t, torch.Tensor):
                continue
            if t.dtype in _WIDE and not allowed and op not in self.wide:
                self.wide[op] = t.dtype
            if t.numel() > _INT32_MAX and op not in self.big:
                self.big[op] = t.numel()
        return out


def dtype_findings(fn, args, *, name: str, entry=None) -> list[Finding]:
    """Run ``fn(*args)`` once under the dtype recorder and return the
    dtype-drift findings (see module docstring): DT002 over the leaves
    of ``entry`` (default: ``args``), DT001/DT003 over every aten op the
    call dispatched. ``args`` may be meta tensors when ``fn`` is plain
    torch (no kernel launch)."""
    out: list[Finding] = []
    for i, leaf in enumerate(tree_leaves(args if entry is None else entry)):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32:
            continue
        desc = f"a {leaf.dtype} tensor" if isinstance(leaf, torch.Tensor) \
            else f"a Python {type(leaf).__name__}"
        out.append(Finding(
            rule="DT002", severity="warning", pass_name="dtype",
            message=f"entry input {i} is {desc}, not a float32 tensor; "
                    f"it promotes or converts every op it meets",
            location=name))

    rec = _DtypeRecorder()
    with rec:
        fn(*args)
    for op, dt in rec.wide.items():
        out.append(Finding(
            rule="DT001", severity="error", pass_name="dtype",
            message=f"{dt} value flows through '{op}' — unintended "
                    f"64-bit promotion doubles every buffer it touches; "
                    f"pin the input dtype, cast at the boundary, or scope "
                    f"a deliberate use with allow_f64(reason)",
            location=name))
    for op, numel in rec.big.items():
        out.append(Finding(
            rule="DT003", severity="warning", pass_name="dtype",
            message=f"'{op}' touches a tensor of {numel:,} elements "
                    f"(> int32 max); flattened int32 indexing (edge "
                    f"gathers, dense shard grids) wraps at this scale — "
                    f"use int64 indices or shard the tensor",
            location=name))
    return out


# --------------------------------------------------------------------------
# Executable-level entry
# --------------------------------------------------------------------------

def _grouped_features(exe) -> torch.Tensor:
    """The compiled features, or zeros of their shape."""
    if exe._h_grouped is not None:
        return exe._h_grouped
    return torch.zeros((exe.gt.S, exe.gt.n, exe.spec.in_dim),
                       dtype=torch.float32, device=exe.device)


def check_executable(exe, *, probe: bool = False,
                     batch_sizes=(1, 2, 3, 5, 7),
                     graph=None) -> list[Finding]:
    """Analysis of one compiled
    :class:`~repro_torch.runtime.executable.Executable`:

      * RT002 over the parameter tree (Python-number leaves),
      * DT001/2/3 over one real forward under the dtype recorder (zero
        features when compiled without features),
      * with ``probe``: RT003 build stability of the full-graph forward
        (two more forwards build and compile nothing) and of the
        node-batch path (each of ``batch_sizes`` builds nothing),
      * with ``probe`` and a ``graph`` (the GraphData the Executable was
        compiled from): RT003 over the MUTATION path
        (:func:`check_mutation_stability`).

    The probes need compiled features; without them only the static
    passes run.
    """
    name = f"Executable[{exe.spec.arch}]"
    out = python_scalar_leaves(exe.params, name=f"{name}.params")
    with torch.inference_mode():
        out.extend(dtype_findings(exe._forward_fn(),
                                  (exe.params, _grouped_features(exe)),
                                  name=f"{name}.forward"))

    if probe and exe._h_grouped is not None:
        out.extend(build_stability(exe.forward, [()] * 2,
                                   name=f"{name}.forward"))
        if graph is not None:
            out.extend(check_mutation_stability(
                exe, graph.edges, graph.profile.num_nodes, name=name))
        n = exe.gt.num_nodes
        out.extend(build_stability(
            lambda k: exe.forward_nodes(np.arange(min(k, n))),
            [(k,) for k in batch_sizes], name=f"{name}.forward_nodes",
            max_builds=0))
    return out


def check_mutation_stability(exe, edges, num_nodes, deltas=None, *,
                             name: str | None = None) -> list[Finding]:
    """RT003 on the mutation path: push ``deltas`` through the
    incremental patcher (:class:`~repro_torch.graphs.patch.PatchState`
    sized to the Executable's exact edge-list template) and
    ``Executable.update_graph``, with a forward after each. Streaming
    serving depends on in-template edge churn being compile-free, so
    each delta may build at most one index of each kind for its new
    ``GraphTensors`` (one per data group on a mesh) and compile
    nothing.

    A delta that BREAKS the template is the same finding from the other
    side: the patcher compacted (edge-capacity overflow / node growth
    past S·n) and ``update_graph`` refused the new shapes — the
    unpadded/slack=0 known-bad fixture lands here.

    With ``deltas=None`` the probe deletes-then-reinserts one existing
    edge: guaranteed in-capacity, and it leaves the Executable's graph
    bitwise where it started (in a new ``GraphTensors``).
    Caller-supplied deltas are applied for real (the probe is meant for
    throwaway analysis compiles).
    """
    from repro_torch.gnn.models import graph_signature
    from repro_torch.graphs.delta import GraphDelta
    from repro_torch.graphs.patch import PatchState

    name = name or f"Executable[{exe.spec.arch}]"
    loc = f"{name}.update_graph"
    # warm: the pre-mutation builds are legitimate — only growth counts
    exe.forward()

    edges = np.asarray(edges, dtype=np.int64)
    if deltas is None:
        if edges.shape[0] == 0:
            return []
        e = edges[:1]
        deltas = [GraphDelta(del_edges=e), GraphDelta(add_edges=e)]

    norm, loops = graph_signature(exe.spec.arch)
    ps = PatchState(edges, num_nodes, exe.gt.n, normalize=norm,
                    add_self_loops=loops,
                    edge_capacity=int(exe.gt.edge_src.shape[-1]))
    worst, compiled = dict.fromkeys(csr.index_builds(), 0), \
        {"compiles": 0, "graph_builds": 0}
    for d in deltas:
        res = ps.apply(d)
        idx0, cmp0 = _counts()
        try:
            exe.update_graph(ps.to_graph_tensors(device=exe.device),
                             exe._h_grouped)
        except ValueError as err:
            return [Finding(
                rule="RT003", severity="error", pass_name="retrace",
                message=f"delta {d.summary()} broke the graph template "
                        f"({err}; patcher "
                        f"{'compacted' if res.rebuilt else 'patched'}) — "
                        f"this mutation forces a recompile mid-serve; "
                        f"build with edge slack "
                        f"(compile(mutable_graph=True)) or shrink the "
                        f"delta",
                location=loc)]
        exe.forward()
        idx1, cmp1 = _counts()
        worst = {k: max(worst[k], v) for k, v in _diff(idx1, idx0).items()}
        compiled = {k: compiled[k] + v
                    for k, v in _diff(cmp1, cmp0).items()}
    # a sharded Executable keeps one index per data group
    per_graph = getattr(exe, "n_data", 1)
    if any(v > per_graph for v in worst.values()) or \
            any(compiled.values()):
        return [Finding(
            rule="RT003", severity="error", pass_name="retrace",
            message=f"{len(deltas)} in-template delta(s): up to {worst} "
                    f"index build(s) per delta (expected <= {per_graph} "
                    f"of each kind per new GraphTensors), "
                    f"{compiled['compiles']} compile(s) and "
                    f"{compiled['graph_builds']} graph build(s); graph "
                    f"mutation is rebuilding more than the new graph",
            location=loc)]
    return []
