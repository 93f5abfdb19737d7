"""The (data, model) meshes a sharded GNN program runs on.

A mesh program (:mod:`repro_torch.dist.gnn`) is written once, per rank,
over a LIST holding one value per rank this process runs
(:attr:`local_ranks`, rank r = g·n_model + m for data index g and model
index m), with three mesh operations beside plain per-rank torch code:

  * ``axis_index("data" | "model")`` — each local rank's coordinate;
  * ``all_gather(xs, axis)`` — the peers' values concatenated along dim
    0, in axis order (the reference's ``all_gather(tiled=True)``);
  * ``psum(xs, axis)`` — the peers' values summed.

Two meshes run it, and the caller picks one; nothing switches from one
to the other:

  * :class:`LocalMesh` runs every rank in this process, on one
    ``torch.device``, in lockstep: a collective is a ``cat`` or a sum
    over the peers' list entries, which autograd differentiates. It is
    the counterpart of the reference's virtual host devices
    (``--xla_force_host_platform_device_count``). On a card its TIMES say
    nothing about scaling — the ranks' kernels run one after another on
    the one card — but its counted bytes are exactly what a mesh of that
    many devices sends.
  * :class:`ProcessGroupMesh` runs one rank per process over
    ``torch.distributed`` (gloo on the CPU, NCCL across cards), with
    differentiable collectives (autograd Functions over
    ``torch.distributed``'s, whose backward is the transposed collective)
    on subgroups made with ``new_group``. Its device is a card unless the
    caller passes another.

Every collective appends one entry per SPMD instruction to the mesh's
comm log (:mod:`repro_torch.dist.comm`) while a
``mesh.comm.capture()`` is open; autograd's transposes (an all-gather's
reduce-scatter, a psum's all-reduce) log as they run, and the train
step's data-parallel gradient all-reduce logs in
:meth:`reduce_gradients`. :meth:`assemble`, which builds the caller's
output rows, sits outside the comm contract, as in the reference.

The log records the program's contract: what a mesh of real devices
issues. On NCCL that is what is sent. gloo has no reduce-scatter on a
subgroup, so there an all-gather's transpose, logged as the
reduce-scatter of one piece's bytes, is emulated with an all-reduce of
the whole cotangent and a narrow, which sends more than the log says.
"""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.dist.comm import CommRecorder

AXES = ("data", "model")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tap(torch.autograd.Function):
    """Identity on its tensors; its backward calls ``on_backward`` once
    (autograd runs a node's backward once for all its outputs)."""

    @staticmethod
    def forward(ctx, on_backward, *xs):
        ctx.on_backward = on_backward
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.on_backward()
        return (None, *grads)


def _tap(xs: list, on_backward) -> list:
    """``xs``, with ``on_backward`` called when autograd reaches them."""
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
        return list(xs)
    return list(_Tap.apply(on_backward, *xs))


def _check_axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")


class _Mesh:
    """What both meshes share: the shape and the comm log."""

    def __init__(self, n_data: int, n_model: int, device):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={n_data} "
                             f"model={n_model}")
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.device = torch.device(device)
        self.comm = CommRecorder()

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def axis_size(self, axis: str) -> int:
        _check_axis(axis)
        return self.n_data if axis == "data" else self.n_model

    def axis_index(self, axis: str) -> list[int]:
        _check_axis(axis)
        return [g if axis == "data" else m for g, m in self.local_ranks]

    def _log_transpose(self, kind: str, axis: str, nbytes: int, g: int):
        return lambda: self.comm.record(kind, axis, nbytes, g, backward=True)


class LocalMesh(_Mesh):
    """Every rank of a (data, model) mesh in this process, on ``device``.

    ``local_ranks`` is the whole mesh. A collective's result is ONE
    tensor shared by the peers of each group (model peers of a data group
    hold the same psum result, data peers the same gathered block).
    """

    def __init__(self, n_data: int, n_model: int,
                 device: torch.device | str):
        super().__init__(n_data, n_model, device)
        self.local_ranks = [(g, m) for g in range(self.n_data)
                            for m in range(self.n_model)]

    def _groups(self, axis: str) -> list[list[int]]:
        """Each group's members (list positions), in axis order."""
        nd, nm = self.n_data, self.n_model
        if axis == "data":
            return [[g * nm + m for g in range(nd)] for m in range(nm)]
        return [[g * nm + m for m in range(nm)] for g in range(nd)]

    def _collective(self, xs, axis, combine, kind, transpose):
        """``combine`` each group's values into one result the group
        shares; log ``kind``, and ``transpose`` (of one rank's value's
        bytes) when autograd reaches the results."""
        _check_axis(axis)
        if len(xs) != self.size:
            raise ValueError(f"a LocalMesh program holds {self.size} "
                             f"values, got {len(xs)}")
        groups = self._groups(axis)
        g = len(groups[0])
        if g == 1:
            return list(xs)
        outs = [combine([xs[r] for r in grp]) for grp in groups]
        self.comm.record(kind, axis, _nbytes(outs[0]), g)
        outs = _tap(outs, self._log_transpose(transpose, axis,
                                              _nbytes(xs[0]), g))
        res: list = [None] * len(xs)
        for grp, out in zip(groups, outs):
            for r in grp:
                res[r] = out
        return res

    def all_gather(self, xs: list, axis: str) -> list:
        """Concatenate the peers' values along dim 0, in axis order.
        Transpose: a reduce-scatter of the scattered piece's bytes."""
        return self._collective(xs, axis, torch.cat, "all-gather",
                                "reduce-scatter")

    def psum(self, xs: list, axis: str) -> list:
        """Sum the peers' values, in axis order. Transpose: an
        all-reduce of the same bytes."""
        return self._collective(
            xs, axis, lambda v: functools.reduce(operator.add, v),
            "all-reduce", "all-reduce")

    def assemble(self, xs: list) -> torch.Tensor:
        """The caller's rows: each data group's value, in data order (a
        group's model peers hold the same value after the last psum, and
        model rank 0's copy is taken). Not a collective of the program."""
        parts = [xs[g * self.n_model] for g in range(self.n_data)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def reduce_gradients(self, grads: list) -> list:
        """The data-parallel gradient all-reduce of replicated
        parameters, one per leaf over the whole mesh. The ranks here share
        the parameter tensors, so autograd has already summed their
        contributions: only the instruction is logged."""
        for t in grads:
            self.comm.record("all-reduce", "world", _nbytes(t), self.size)
        return list(grads)


class _AllReduce(torch.autograd.Function):
    """Sum over a subgroup; backward, the same sum of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """All-gather over a subgroup along dim 0; backward, the transposed
    reduce-scatter (NCCL's own; elsewhere an all-reduce of the cotangent
    and this rank's piece of it). ``torch.distributed.nn.functional.
    all_gather`` emulates that backward on gloo with scatters that
    address subgroup ranks as global ones, which fails on a subgroup."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.size, ctx.index, ctx.rows = group, size, index, \
            x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = grad.new_empty((ctx.rows, *grad.shape[1:]))
            dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        else:
            total = grad.clone()
            dist.all_reduce(total, group=ctx.group)
            out = total.narrow(0, ctx.index * ctx.rows, ctx.rows)
        return out, None, None, None


class _Inject(torch.autograd.Function):
    """Identity; backward, the cotangent where ``inject`` is true, else
    zero — the once-per-data-group entry of the loss that
    :class:`_Assemble` makes, for a mesh with one data group."""

    @staticmethod
    def forward(ctx, x, inject):
        ctx.inject = inject
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.inject else torch.zeros_like(grad)), None


class _Assemble(torch.autograd.Function):
    """Forward: gather each data group's rows to every rank (outside the
    comm contract). Backward: this rank's rows of the cotangent where it
    is model rank 0, else zero — every rank computes the same loss on the
    assembled rows, and the psum's transpose adds the model peers'
    cotangents, so the loss must enter once per data group."""

    @staticmethod
    def forward(ctx, x, group, size, index, inject):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.index, ctx.rows, ctx.inject = index, x.shape[0], inject
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        piece = grad.narrow(0, ctx.index * ctx.rows, ctx.rows)
        return (piece if ctx.inject else torch.zeros_like(piece),
                None, None, None, None)


class ProcessGroupMesh(_Mesh):
    """One rank of a (data, model) mesh per process, over
    ``torch.distributed`` (initialized by the caller with a world of
    ``n_data · n_model`` processes; rank r is (r // n_model, r % n_model)).

    Every rank creates the data-axis and model-axis subgroups in the same
    order. ``device`` defaults to the card ``rank % device_count``,
    whatever the backend (gloo carries CUDA tensors too), and raises
    without a card: a CPU run passes ``device="cpu"``. The program's
    lists hold this rank's one value."""

    def __init__(self, n_data: int, n_model: int, *, device=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs "
                               "torch.distributed.init_process_group first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != n_data * n_model:
            raise ValueError(f"a {n_data} x {n_model} mesh needs "
                             f"{n_data * n_model} processes, the world has "
                             f"{world}")
        if device is None:
            from repro_torch.runtime.api import resolve_device

            resolve_device(None)            # raises without a card
            device = f"cuda:{rank % torch.cuda.device_count()}"
        super().__init__(n_data, n_model, device)
        g, m = divmod(rank, self.n_model)
        self.local_ranks = [(g, m)]
        nd, nm = self.n_data, self.n_model
        data_groups = [dist.new_group([gg * nm + mm for gg in range(nd)])
                       for mm in range(nm)]
        model_groups = [dist.new_group([gg * nm + mm for mm in range(nm)])
                        for gg in range(nd)]
        self._group = {"data": data_groups[m], "model": model_groups[g]}

    def all_gather(self, xs: list, axis: str) -> list:
        g = self.axis_size(axis)
        if g == 1:
            return list(xs)
        (x,) = xs
        out = _AllGather.apply(x, self._group[axis], g,
                               self.axis_index(axis)[0])
        self.comm.record("all-gather", axis, _nbytes(out), g)
        return _tap([out], self._log_transpose("reduce-scatter", axis,
                                               _nbytes(x), g))

    def psum(self, xs: list, axis: str) -> list:
        g = self.axis_size(axis)
        if g == 1:
            return list(xs)
        (x,) = xs
        out = _AllReduce.apply(x, self._group[axis])
        self.comm.record("all-reduce", axis, _nbytes(out), g)
        return _tap([out], self._log_transpose("all-reduce", axis,
                                               _nbytes(x), g))

    def assemble(self, xs: list) -> torch.Tensor:
        (x,) = xs
        g, m = self.local_ranks[0]
        if self.n_data == 1:
            return _Inject.apply(x, m == 0)
        return _Assemble.apply(x, self._group["data"], self.n_data, g,
                               m == 0)

    def reduce_gradients(self, grads: list) -> list:
        """Sum each replicated parameter's gradient over every rank."""
        import torch.distributed as dist

        out = []
        for t in grads:
            t = t.contiguous().clone()
            if self.size > 1:
                dist.all_reduce(t)
            self.comm.record("all-reduce", "world", _nbytes(t), self.size)
            out.append(t)
        return out
