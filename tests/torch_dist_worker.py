"""One rank of the four-process ``ProcessGroupMesh`` run that the tests
spawn: gloo on the CPU (``tests/test_torch_dist_mesh.py``) or NCCL on
four cards (``tests/test_torch_dist_cuda.py``). The four processes form
a data 2 x model 2 mesh, then a data 1 x model 4 one. Imports the port
only (no JAX), so each process starts quickly."""
import datetime

import torch
import torch.distributed as dist

from repro_torch import runtime
from repro_torch.dist.mesh import ProcessGroupMesh
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.runtime.executable import _flatten_params

# the run both meshes make: cora at scale 0.3, shards of 64 nodes
DATASET = dict(name="cora", seed=0, scale=0.3)
SHARD_N = 64
HIDDEN = 8
# (n_data, n_model) -> the (arch, partition) cases run on that mesh; the
# 1 x 4 mesh has no data axis, so its loss enters through assemble's
# one-data-group path
CASES = {(2, 2): (("gcn", "contiguous"), ("gin", "fennel")),
         (1, 4): (("gcn", "contiguous"),)}


def run_case(mesh, arch: str, partition: str,
             backend: str = "reference") -> dict:
    """Logits, one train step's gradients and its comm log on ``mesh``."""
    ds = make_dataset(**DATASET)
    prof = ds.profile
    spec = ZooSpec(arch, prof.feature_dim, HIDDEN, prof.num_classes)
    exe = runtime.compile(spec, ds, device=mesh.device, backend=backend,
                          max_shard_n=SHARD_N, mesh=mesh,
                          partition=partition, hub_cache=32, seed=1)
    logits = exe.forward()
    tr = runtime.TrainableExecutable(exe, ds.labels,
                                     train_mask=ds.train_mask)
    with mesh.comm.capture() as log:
        _, _, grads = tr.loss_and_grads(tr.params, tr.data(0))
    return {"logits": logits.cpu().numpy(), "grads": _flatten_params(grads),
            "comm": [(e.kind, e.axis, e.nbytes, e.group, e.backward)
                     for e in log.entries]}


def worker(rank: int, world: int, store_path: str, queue,
           backend: str = "gloo") -> None:
    """Rank ``rank`` of the run: gloo with the plain versions on the CPU,
    or NCCL with the kernels on card ``rank``; rank 0 puts every case's
    result on ``queue``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        device = f"cuda:{rank}" if backend == "nccl" else "cpu"
        kernels = "cuda" if backend == "nccl" else "reference"
        out = {}
        for shape, cases in CASES.items():
            mesh = ProcessGroupMesh(*shape, device=device)
            for case in cases:
                out[shape, case] = run_case(mesh, *case, backend=kernels)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()
