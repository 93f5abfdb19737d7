"""Streaming graphs on the card: copy-on-write patches and exact parity.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; run them on the card with ``python -m pytest -m cuda
tests/test_torch_stream_cuda.py``. The CPU tests in
``tests/test_torch_stream.py`` hold the same paths to the reference
package; these hold the card's patched tensors and kernels to a fresh
build on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.gnn.models import ARCHS, ZooSpec
from repro_torch.graphs import PatchState, apply_to_graph_data
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import _lib, csr
from repro_torch.runtime.forward import build_graph_tensors
from repro_torch.serving import Completed, SchedulerConfig, Server
from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
from repro_torch.stream import StreamTrainer, random_delta
from torch_launches import FORWARD_LAUNCHES

FIELDS = ("blocks", "edge_src", "edge_dst", "edge_valid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_stream_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launches().items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn", "sage_max"])
def test_cuda_patch_is_copy_on_write(cuda, arch):
    ds = make_dataset("cora", seed=0)
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 512, arch)
    gt0 = ps.to_graph_tensors(device=cuda)
    lin0, gat0 = gt0.linear_index, gt0.gather_index
    snap = {k: getattr(gt0, k).clone() for k in FIELDS}
    rng = np.random.default_rng(0)
    prev = gt0
    for _ in range(3):
        d = random_delta(ds, rng, edge_ops=8, p_node=0.5)
        apply_to_graph_data(ds, d)
        res = ps.apply(d)
        assert not res.rebuilt
        prev = ps.to_graph_tensors(prev=prev, pairs=res.pairs)
        assert prev.device.type == "cuda"
    torch.cuda.synchronize()
    for k, t in snap.items():
        assert torch.equal(getattr(gt0, k), t), k
    assert gt0.linear_index is lin0 and gt0.gather_index is gat0
    fresh = build_graph_tensors(ds.edges, ds.profile.num_nodes, 512, arch,
                                cuda)
    assert torch.equal(prev.blocks, fresh.blocks)
    for a, b in ((prev.linear_index, fresh.linear_index),
                 (prev.gather_index, fresh.gather_index),
                 (lin0, csr.linear_index(snap["blocks"]))):
        for name in a.__dataclass_fields__:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_cuda_served_logits_equal_a_fresh_compile_after_deltas(cuda):
    ds = make_dataset("cora", seed=0)
    prof = ds.profile
    eng = GNNServeEngine(device=cuda, max_shard_n=512, streaming=True)
    eng.register_graph("g", ds)
    for a in sorted(ARCHS):
        eng.register_model(a, ZooSpec(a, prof.feature_dim, 16,
                                      prof.num_classes), seed=1)
    srv = Server(eng, SchedulerConfig(max_batch_size=8))
    trainer = StreamTrainer(srv, graph="g", model="gcn", batch_nodes=32,
                            fanout=(5, 5), steps_per_round=3,
                            log=lambda s: None)
    rng = np.random.default_rng(1)
    tickets = []
    for i in range(6):
        for a in sorted(ARCHS):
            tickets.append(srv.submit(NodeRequest(
                "g", rng.integers(0, ds.profile.num_nodes, 8), model=a)))
        srv.drain()
        srv.mutate("g", random_delta(ds, rng, edge_ops=8, p_node=0.3))
        if i % 3 == 2:
            assert not trainer.round()["skipped"]
    srv.drain()
    assert all(isinstance(t.result(), Completed) for t in tickets)
    s = eng.stats
    assert s["graph_recompiles"] == 0 and s["graph_patch_rebuilds"] == 0
    assert trainer.stats["rebuilds"] == 0
    store = runtime.GraphStore()
    for a in sorted(ARCHS):
        exe = eng.executable(a, "g")
        logits, launches = _launched(exe.forward)
        assert launches == FORWARD_LAUNCHES[a], a
        fresh = runtime.compile(exe.spec, ds, device=cuda,
                                params=exe.params, max_shard_n=512,
                                store=store)
        assert torch.equal(logits, fresh.forward()), a
        ref = runtime.compile(exe.spec, ds, device=cuda,
                              backend="reference", params=exe.params,
                              max_shard_n=512, store=store)
        torch.testing.assert_close(logits, ref.forward(), atol=1e-4,
                                   rtol=1e-4)
