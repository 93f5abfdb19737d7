"""Training, gin and gat through the hand-written kernels on the card.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; run them on the card with ``python -m pytest -m cuda
tests/test_torch_train_cuda.py``. The ``cuda`` backend (the kernels
forward; autograd of the plain versions backward) is held to the
``reference`` backend (the plain versions throughout) on the same card:
logits within atol = rtol = 1e-4, gradients per parameter within a
relative norm ``GRAD_REL`` (as ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.gnn.models import ARCHS, ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import _lib, csr
from repro_torch.kernels.registry import resolve
from repro_torch.training.optimizer import tree_leaves
from torch_launches import FORWARD_LAUNCHES

TOL = dict(atol=1e-4, rtol=1e-4)
# ||g_cuda - g_reference|| / ||g_reference|| per parameter. The backward
# is the same plain autograd on both sides; only the forward differs
# (3xTF32 products, other summation orders: ~1e-7 relative), and it
# reaches the gradient through the saved activations. 1e-4 leaves ~100x.
GRAD_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_train_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cora():
    return make_dataset("cora", seed=0)


def _spec(ds, arch):
    return ZooSpec(arch, ds.profile.feature_dim, 16, ds.profile.num_classes)


def _launched(fn):
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launches().items() if v}


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_logits_grads_and_launches_match_reference(cuda, cora, arch):
    """Full-scale cora: logits (bitwise repeatable) and step-0 gradients
    through the kernels against the reference backend; a forward and a
    train step launch the arch's kernels, the step no more than its
    forward."""
    store = runtime.GraphStore()
    exe = runtime.compile(_spec(cora, arch), cora, device=cuda,
                          max_shard_n=512, store=store)
    plain = runtime.compile(_spec(cora, arch), cora, device=cuda,
                            backend="reference", params=exe.params,
                            max_shard_n=512, store=store)
    logits, launches = _launched(exe.forward)
    assert launches == FORWARD_LAUNCHES[arch]
    torch.testing.assert_close(logits, plain.forward(), **TOL)
    assert torch.equal(exe.forward(), logits)     # one summation order

    tr = runtime.TrainableExecutable(exe, cora.labels,
                                     train_mask=cora.train_mask)
    tr_plain = runtime.TrainableExecutable(plain, cora.labels,
                                           train_mask=cora.train_mask)
    (loss, _, grads), launches = _launched(
        lambda: tr.loss_and_grads(tr.params, tr.data(0)))
    assert launches == FORWARD_LAUNCHES[arch]
    loss_plain, _, grads_plain = tr_plain.loss_and_grads(tr_plain.params,
                                                         tr_plain.data(0))
    torch.testing.assert_close(loss, loss_plain, **TOL)
    for g, gp in zip(tree_leaves(grads), tree_leaves(grads_plain)):
        assert torch.isfinite(g).all()
        assert _rel(g, gp) <= GRAD_REL
    _, launches = _launched(lambda: tr.step_fn(tr.params, tr.opt_state,
                                               tr.data(0)))
    assert launches == FORWARD_LAUNCHES[arch]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["dense", "aggregate", "indexed", "fused",
                                "max", "sum"])
def test_cuda_op_grads_match_reference(cuda, op):
    """Each differentiable op on the card: the output and the gradients
    of every input against the reference backend's autograd."""
    r = np.random.default_rng(7)
    s, n, d = 3, 70, 20
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    a = torch.from_numpy(((r.random((s, s, n, n)) < 0.05)
                          * r.random((s, s, n, n))).astype(np.float32))
    a = a.to(cuda)
    index = csr.linear_index(a)
    es = torch.from_numpy(r.integers(0, n, (s, s, 60)).astype(np.int32))
    ed = torch.from_numpy(r.integers(0, n, (s, s, 60)).astype(np.int32))
    ev = torch.from_numpy(r.random((s, s, 60)) < 0.7)
    es, ed, ev = es.to(cuda), ed.to(cuda), ev.to(cuda)
    gindex = csr.gather_index(es, ed, ev, n)
    inputs = {
        "dense": (rand(s * n, d), rand(d, 12), rand(12)),
        "aggregate": (rand(s, n, d),),
        "indexed": (torch.rand(index.val.shape, generator=gen, device=cuda),
                    rand(s, n, d)),
        "fused": (rand(s, n, d), rand(d, 12)),
        "max": (rand(s, n, d),),
        "sum": (rand(s, n, d),),
    }[op]

    def call(backend, *xs):
        be = resolve(backend)
        if op == "dense":
            return be.dense_matmul(*xs, activation="relu")
        if op == "aggregate":
            return be.graph_aggregate(a, xs[0], index=index)
        if op == "indexed":
            return be.graph_aggregate_indexed(
                dataclasses.replace(index, val=xs[0]), xs[1])
        if op == "fused":
            return be.fused_aggregate_extract(a, *xs, activation="relu",
                                              index=index)
        return be.gather_aggregate(es, ed, ev, xs[0], op=op, index=gindex)

    results = []
    for backend in ("cuda", "reference"):
        xs = [x.clone().requires_grad_() for x in inputs]
        out = call(backend, *xs)
        cot = torch.ones_like(out)
        results.append((out.detach(),
                        torch.autograd.grad(out, xs, cot)))
    (out, grads), (out_plain, grads_plain) = results
    torch.testing.assert_close(out, out_plain, **TOL)
    for g, gp in zip(grads, grads_plain):
        torch.testing.assert_close(g, gp, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn", "sage_mean", "gin"])
def test_cuda_fit_trains_cora_to_accuracy(cuda, cora, arch):
    """The reference's gate at full-scale cora on the card: >= 0.75 train
    accuracy within 150 full-batch steps; the trained executable serves
    the trained weights."""
    res = runtime.fit(_spec(cora, arch), cora, steps=150, lr=1e-2,
                      device=cuda, max_shard_n=512, log=lambda s: None)
    acc = res.train_accuracy()
    assert acc >= 0.75, f"{arch}: train acc {acc:.3f} < 0.75"
    assert res.history[-1][1] < 0.7 * res.history[0][1]
    fresh = runtime.compile(_spec(cora, arch), cora, device=cuda,
                            params=res.params, max_shard_n=512)
    torch.testing.assert_close(res.executable.forward(), fresh.forward(),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gat", "sage_max"])
def test_cuda_mini_batch_fit_learns(cuda, cora, arch):
    res = runtime.fit(_spec(cora, arch), cora, steps=20, lr=1e-2,
                      batch_nodes=128, fanout=(5, 5), device=cuda,
                      max_shard_n=512, log=lambda s: None)
    assert np.isfinite(res.history[-1][1])
    assert res.history[-1][1] < res.history[0][1]
