"""Sharded GNN execution on the card: a ``LocalMesh`` forward and one
train step through the kernels against the ``reference`` backend, and
(on a machine with four cards) a ``ProcessGroupMesh`` on NCCL against
the ``LocalMesh``.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; run them on the card with ``python -m pytest -m cuda
tests/test_torch_dist_cuda.py``. The CPU tests in
``tests/test_torch_dist_exec.py`` and ``tests/test_torch_dist_train.py``
hold the same program to the JAX reference.
"""
import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.runtime.executable import _flatten_params

GRAD_REL = 1e-4
# kernel launches of one sharded forward on a data 4 x model 2 mesh
# (2 layers, 8 ranks): one shard_spmm per rank and layer; dense_engine
# gcn 1, sage_mean and gin 2 per rank and layer
MESH_LAUNCHES = {
    "gcn": {"shard_spmm": 16, "dense_engine": 16},
    "sage_mean": {"shard_spmm": 16, "dense_engine": 32},
    "gin": {"shard_spmm": 16, "dense_engine": 32},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_dist_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launches().items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
@pytest.mark.parametrize("arch", ["gcn", "sage_mean", "gin"])
def test_cuda_sharded_forward_matches_reference(cuda, arch, partition):
    ds = make_dataset("cora", seed=0)
    prof = ds.profile
    spec = ZooSpec(arch, prof.feature_dim, 16, prof.num_classes)
    mesh = make_mesh_for(8, model_parallel=2, device=cuda)
    kw = dict(max_shard_n=256, mesh=mesh, partition=partition,
              hub_cache=256, seed=0)
    exe = runtime.compile(spec, ds, **kw)
    ref = runtime.compile(spec, ds, backend="reference", **kw)
    single = runtime.compile(spec, ds, device=cuda, max_shard_n=256, seed=0)
    logits, launches = _launched(exe.forward)
    assert launches == MESH_LAUNCHES[arch]
    torch.testing.assert_close(logits, ref.forward(), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits, single.forward(), atol=1e-4,
                               rtol=1e-4)
    exe.verify_comm(rtol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
def test_cuda_sharded_train_step_matches_reference(cuda, partition):
    ds = make_dataset("cora", seed=0)
    prof = ds.profile
    spec = ZooSpec("gin", prof.feature_dim, 16, prof.num_classes)
    mesh = make_mesh_for(8, model_parallel=2, device=cuda)
    grads = {}
    for backend in ("cuda", "reference"):
        exe = runtime.compile(spec, ds, backend=backend, max_shard_n=256,
                              mesh=mesh, partition=partition, seed=0)
        tr = runtime.TrainableExecutable(exe, ds.labels,
                                         train_mask=ds.train_mask)
        batch = tr.data(0)
        (_, _, g), launches = _launched(
            lambda: tr.loss_and_grads(tr.params, batch))
        if backend == "cuda":
            # a train step launches exactly its forward's kernels
            assert launches == MESH_LAUNCHES["gin"]
        grads[backend] = _flatten_params(g)
    for k, want in grads["reference"].items():
        got = grads["cuda"][k]
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= GRAD_REL and np.isfinite(got).all(), (k, rel)


@pytest.mark.cuda
def test_cuda_process_group_mesh_on_nccl_matches_local_mesh(cuda, tmp_path):
    """Four processes, one card each, a data 2 x model 2 and a data 1 x
    model 4 ProcessGroupMesh on NCCL through the kernels: rank 0's
    logits, one step's gradients and its comm log equal a LocalMesh's
    on card 0."""
    from test_torch_dist_mesh import (assert_same_runs,
                                      spawn_process_group_mesh)

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a 2 x 2 ProcessGroupMesh on "
                    "NCCL)")
    _lib.lib()        # build the kernels once, before the ranks load them
    got = spawn_process_group_mesh(tmp_path, "nccl")
    assert_same_runs(got, "cuda:0", "cuda")
