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

Four names of the reference's ``repro.dist`` need no counterpart:

  * ``make_mesh`` and ``abstract_mesh`` (``dist/compat.py``) paper over
    jax-version differences in building a ``jax.sharding.Mesh``; the port
    builds a ``DeviceMesh`` (``launch/mesh.py``), or hands
    ``ShardingRules`` an ``{axis: size}`` mapping where only specs are
    needed;
  * ``analyze_collectives`` and ``type_bytes`` (``dist/hlo_analysis.py``)
    parse compiled XLA HLO text, which PyTorch does not produce: the
    port's collectives append to a :class:`CommLog` as they run, and
    :class:`~repro_torch.dist.comm.CollectiveLogger` counts a traced
    step's.
"""
from repro_torch.dist.comm import CollectiveStats, CommLog, wire_bytes
from repro_torch.dist.mesh import LocalMesh, ProcessGroupMesh
from repro_torch.dist.shardings import ShardingRules

__all__ = ["ShardingRules", "CollectiveStats", "CommLog", "wire_bytes",
           "LocalMesh", "ProcessGroupMesh"]
