"""Mesh construction for the launchers and ``runtime.compile(mesh=...)``.

The port of ``repro.launch.mesh``'s elastic half. A function, not a
module-level constant, so importing this module touches no device.

``make_mesh_for`` builds a :class:`~repro_torch.dist.mesh.LocalMesh`:
every rank of the (data, model) mesh in this process, on one device
(``cuda`` unless the caller names another). On one card its ranks run in
turn, so its times say nothing about scaling; its counted collective
bytes are what a mesh of that many devices sends. A mesh of one rank
per process is :class:`~repro_torch.dist.mesh.ProcessGroupMesh`, which
the caller builds after ``torch.distributed.init_process_group``.

The reference's ``make_production_mesh`` (TPU pod meshes for the LM
stack) is ROADMAP.md Queue 1 item 7.9.
"""
from __future__ import annotations

import torch

from repro_torch.dist.mesh import LocalMesh


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
