"""Mesh construction for the launchers and ``runtime.compile(mesh=...)``:
the port of ``repro.launch.mesh``. Functions, not module-level
constants, so importing this module touches no device and no process
group.

:func:`make_production_mesh` builds the reference's production meshes as
a ``torch.distributed`` ``DeviceMesh``: a single pod of (16, 16) devices
``("data", "model")``, or two pods, (2, 16, 16) ``("pod", "data",
"model")``, with the leading ``pod`` axis the slowest link. The process
group must exist and hold exactly that many ranks (``torchrun`` on the
cards, or the dry-run's fake group). The shapes are the reference's, so
``dist.shardings.ShardingRules`` gives the reference's specs on them.

``make_mesh_for`` builds the GNN runtime's
:class:`~repro_torch.dist.mesh.LocalMesh`: every rank of the (data,
model) mesh in this process, on one device (``cuda`` unless the caller
names another). On one card its ranks run in turn, so its times say
nothing about scaling; its counted collective bytes are what a mesh of
that many devices sends. A mesh of one rank per process is
:class:`~repro_torch.dist.mesh.ProcessGroupMesh`, which the caller builds
after ``torch.distributed.init_process_group``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.mesh import LocalMesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group of
    256 (or, ``multi_pod``, 512) ranks, on ``device_type`` devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise SystemExit(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs {need} devices but the process group has {have}; run "
            f"it under torchrun with {need} ranks (e.g. --nnodes "
            f"{need // 8} --nproc-per-node 8 on 8-card hosts)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_for(devices: int, *, model_parallel: int = 16,
                  device: torch.device | str | None = None) -> LocalMesh:
    """A (devices // model_parallel, model_parallel) mesh on ``device``
    (None: ``cuda``, which raises without a card)."""
    from repro_torch.runtime.api import resolve_device

    assert devices % model_parallel == 0, (devices, model_parallel)
    return LocalMesh(devices // model_parallel, model_parallel,
                     resolve_device(device))


def mesh_from_cli(devices: int, model_parallel: int,
                  device: torch.device | str | None = None) -> LocalMesh:
    """Launcher-side ``--mesh N --model-parallel M`` handling, shared by
    serve.py, train_gnn.py and stream.py: validate the shape and build
    the mesh on ``device``."""
    if devices < 1 or model_parallel < 1 or devices % model_parallel:
        raise SystemExit(f"--mesh {devices} must be a positive multiple of "
                         f"--model-parallel {model_parallel}")
    return make_mesh_for(devices, model_parallel=model_parallel,
                         device=device)
