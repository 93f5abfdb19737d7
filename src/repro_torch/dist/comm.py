"""Collective-traffic accounting: the comm log every mesh collective
appends to.

The counterpart of the reference's ``dist/hlo_analysis.py``, which
parses the collectives of a compiled XLA module. The port runs eagerly,
so there is no module to parse: each collective a mesh program issues
(:mod:`repro_torch.dist.mesh`) appends one :class:`CommEntry` to the
mesh's :class:`CommLog` instead, and :meth:`CommLog.stats` sums the log
into the reference's :class:`CollectiveStats`.

One entry per SPMD instruction, not per group: an all-gather over
``data`` on a 4 × 2 mesh runs as two groups (one per model rank) but is
ONE instruction of the program, as the reference's HLO holds one
``all-gather`` for it. ``B`` is the instruction's result bytes on one
participant, and the wire bytes follow the reference's ring convention
(``hlo_analysis._wire_bytes``) with ``g`` the group size:

    all-gather        (g-1)   · B      (B = the gathered result)
    all-reduce      2·(g-1)/g · B
    reduce-scatter    (g-1)/g · B      (B = the scattered result)

    all-to-all        (g-1)/g · B

A collective over an axis of size 1 moves nothing and is not logged (a
1-rank mesh logs nothing: the contract's CC004).

A DTensor program issues its collectives through PyTorch's functional
collectives; :class:`CollectiveLogger`, a dispatch mode, logs each of
them (their result bytes on this rank and their group size) into a
:class:`CommLog`, one entry per call, with the same formulas.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Ring-algorithm wire bytes of one instruction (module docstring)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return float(nbytes) * (g - 1)
    if kind == "all-reduce":
        return float(nbytes) * 2.0 * (g - 1) / g
    if kind in ("reduce-scatter", "all-to-all"):
        return float(nbytes) * (g - 1) / g
    raise ValueError(f"unknown collective kind {kind!r}; choose {KINDS}")


@dataclasses.dataclass(frozen=True)
class CommEntry:
    """One collective instruction of a mesh program."""

    kind: str           # one of KINDS
    axis: str           # "data", "model" or "world"
    nbytes: int         # B: the result bytes on one participant
    group: int          # g: participants per group
    backward: bool = False   # issued by autograd (a forward op's transpose)

    @property
    def wire_bytes(self) -> float:
        return wire_bytes(self.kind, self.nbytes, self.group)


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective traffic of one logged run (the reference's
    ``dist.hlo_analysis.CollectiveStats``)."""

    operand_bytes: dict[str, float]
    wire_bytes: dict[str, float]
    counts: dict[str, int]

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


class CommLog:
    """The collectives a mesh issued, in program order."""

    def __init__(self):
        self.entries: list[CommEntry] = []

    def record(self, kind: str, axis: str, nbytes: int, group: int, *,
               backward: bool = False) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r}; "
                             f"choose {KINDS}")
        if group > 1:
            self.entries.append(CommEntry(kind, axis, int(nbytes),
                                          int(group), backward))

    def stats(self) -> CollectiveStats:
        operand: dict[str, float] = {}
        wire: dict[str, float] = {}
        counts: dict[str, int] = {}
        for e in self.entries:
            operand[e.kind] = operand.get(e.kind, 0.0) + e.nbytes
            wire[e.kind] = wire.get(e.kind, 0.0) + e.wire_bytes
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return CollectiveStats(operand_bytes=operand, wire_bytes=wire,
                               counts=counts)

    def allgather_ops(self) -> list[float]:
        """Per-instruction all-gather wire bytes, in program order (a
        fennel layer shows its hub broadcast, then its halo exchange)."""
        return [e.wire_bytes for e in self.entries
                if e.kind == "all-gather"]


class CommRecorder:
    """Where a mesh's collectives go: into the log of the innermost open
    :meth:`capture`, or nowhere outside one (serving logs nothing)."""

    def __init__(self):
        self._log: CommLog | None = None

    def record(self, kind: str, axis: str, nbytes: int, group: int, *,
               backward: bool = False) -> None:
        if self._log is not None:
            self._log.record(kind, axis, nbytes, group, backward=backward)

    @contextlib.contextmanager
    def capture(self):
        """Log every collective issued inside the block into a fresh
        :class:`CommLog`, which the block receives."""
        outer, self._log = self._log, CommLog()
        try:
            yield self._log
        finally:
            self._log = outer


# the functional collectives a DTensor program issues -> their kinds
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}
# the functional-collective namespace's helpers that move nothing
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


class CollectiveLogger(TorchDispatchMode):
    """Logs every functional collective run under it into :attr:`log` (a
    :class:`CommLog`): its result bytes on this rank and its group size,
    with ``axis`` the mesh dimension of its group (``"world"`` for a
    group of no dimension of ``mesh``). ``wait_tensor`` and
    ``_wrap_tensor_autograd`` move nothing; any other functional
    collective raises, so a count is never silently short.

    DTensor operations pass through (``NotImplemented``): DTensor turns
    each into local operations and collectives, which this mode then
    sees, as ``CommDebugMode`` does. Operations on fake tensors are
    DTensor's inference of global result shapes and are skipped.
    Subclasses extend :meth:`on_local` to see every local operation with
    its result."""

    def __init__(self, mesh):
        super().__init__()
        self.log = CommLog()
        self._axes = {mesh.get_group(i).group_name: name
                      for i, name in enumerate(mesh.mesh_dim_names)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) \
                or isinstance(out, FakeTensor):
            # DTensor's inference of a result's global shape: no work
            return out
        if func.namespace == "_c10d_functional":
            self._collective(func, args, out)
        self.on_local(func, args, kwargs, out)
        return out

    def on_local(self, func, args, kwargs, out) -> None:
        """Called with every local operation and its result."""

    def _collective(self, func, args, out) -> None:
        from torch.distributed.distributed_c10d import \
            _resolve_process_group

        name = func._overloadpacket.__name__
        if name in _NOT_COLLECTIVES:
            return
        if name not in _FUNCTIONAL:
            raise NotImplementedError(f"collective {func} is not logged")
        group = args[-1]
        pg = _resolve_process_group(group) if isinstance(group, str) \
            else group
        gname = group if isinstance(group, str) else pg.group_name
        self.log.record(_FUNCTIONAL[name], self._axes.get(gname, "world"),
                        out.numel() * out.element_size(), pg.size(),
                        backward=torch._C._current_graph_task_id() != -1)
