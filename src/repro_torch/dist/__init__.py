"""repro_torch.dist — sharded GNN execution on a (data, model) mesh.

  * :mod:`repro_torch.dist.mesh` — the meshes a program runs on:
    :class:`LocalMesh` (every rank in this process, on one device) and
    :class:`ProcessGroupMesh` (one rank per process, ``torch.distributed``);
  * :mod:`repro_torch.dist.comm` — the comm log every collective appends
    to and its :class:`CollectiveStats` (the counterpart of the
    reference's ``dist/hlo_analysis.py``);
  * :mod:`repro_torch.dist.gnn` — ``runtime.compile(spec, graph,
    mesh=...)``: a ``ShardedExecutable`` (data axis = dst row groups
    placed by ``graphs/partition.py``, model axis = feature blocks).

  * :mod:`repro_torch.dist.shardings` — the LM stack's logical-axis
    sharding rules (``ShardingRules``: specs, DTensor placements,
    ``constrain``) on a ``torch.distributed`` ``DeviceMesh``.
"""
from repro_torch.dist.comm import CollectiveStats, CommLog, wire_bytes
from repro_torch.dist.mesh import LocalMesh, ProcessGroupMesh

__all__ = ["CollectiveStats", "CommLog", "wire_bytes", "LocalMesh",
           "ProcessGroupMesh"]
