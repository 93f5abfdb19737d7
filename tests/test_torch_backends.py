"""The port's kernel-backend registry: resolution, per-op routing and
``runtime.compile(op_backends=)``.

The cases of the reference's ``tests/test_backends.py::TestResolution``
and ``tests/test_runtime.py``'s per-op tests, under the port's backend
names (``cuda``, ``reference``; the reference package's are ``pallas``,
``jax``, ``reference``). Compiles run on the CPU, where the ``cuda``
backend runs the plain versions, so which backend answered an op is read
from the pinned methods and from a counting backend registered for the
test. The ``REPRO_KERNEL_BACKEND*`` variables are set through
``monkeypatch`` and never outlive a test.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import runtime, tune
from repro_torch.core.engines import DenseEngine, GraphEngine
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import ops, registry
from repro_torch.kernels.registry import ReferenceBackend

CPU = torch.device("cpu")


class _Counting(ReferenceBackend):
    """The plain versions, counting the calls of each op it answers."""

    name = "counting"

    def __init__(self):
        self.calls = {}


def _counted(op):
    def method(self, *args, **kw):
        self.calls[op] = self.calls.get(op, 0) + 1
        return getattr(ReferenceBackend, op)(self, *args, **kw)
    return method


for _op in registry.OP_NAMES:
    setattr(_Counting, _op, _counted(_op))


@pytest.fixture
def counting():
    be = registry.register_backend(_Counting(), aliases=("cnt",))
    yield be
    registry._REGISTRY.pop("counting")
    registry._ALIASES.pop("cnt")


@pytest.fixture(autouse=True)
def _no_backend_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("REPRO_KERNEL_BACKEND"):
            monkeypatch.delenv(key)


def _cora():
    return make_dataset("cora", seed=0, scale=0.05)


def _spec(arch, ds):
    return ZooSpec(arch, ds.profile.feature_dim, 8, ds.profile.num_classes)


def _compile(arch, ds, **kw):
    return runtime.compile(_spec(arch, ds), ds, device=CPU, max_shard_n=64,
                           store=runtime.GraphStore(), **kw)


# ---------------------------------------------------------------------------
# tests/test_backends.py::TestResolution
# ---------------------------------------------------------------------------

class TestResolution:
    def test_env_selects_backend(self, monkeypatch):
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "reference")
        assert registry.resolve(op="dense_matmul").name == "reference"
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")   # the alias
        assert registry.resolve(op="dense_matmul").name == "reference"
        monkeypatch.delenv("REPRO_KERNEL_BACKEND")
        assert registry.resolve(op="dense_matmul").name == \
            registry.DEFAULT_BACKEND == "cuda"
        assert registry.resolve().name == "cuda"

    def test_per_op_env_override(self, monkeypatch, counting):
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "reference")
        monkeypatch.setenv("REPRO_KERNEL_BACKEND_GATHER_AGGREGATE", "cnt")
        assert registry.resolve(op="gather_aggregate") is counting
        assert registry.resolve(op="dense_matmul").name == "reference"
        # op=None skips the per-op variables
        assert registry.resolve().name == "reference"

    def test_explicit_override_wins(self, monkeypatch):
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "reference")
        monkeypatch.setenv("REPRO_KERNEL_BACKEND_DENSE_MATMUL", "reference")
        assert registry.resolve("cuda", op="dense_matmul").name == "cuda"
        be = registry.get_backend("cuda")
        assert registry.resolve(be, op="dense_matmul") is be

    def test_positional_argument_is_a_backend_never_an_op(self):
        """The reference's resolve(op, override) takes the op first; the
        port's first argument stays the backend, so an op name there is
        an unknown backend, not a silent per-op lookup."""
        with pytest.raises(ValueError, match="unknown kernel backend"):
            registry.resolve("dense_matmul")

    def test_composite_backend_routes_per_op(self):
        comp = registry.composite_backend(
            "reference", {"dense_matmul": "cuda"})
        assert comp.dense_matmul.__self__ is registry.get_backend("cuda")
        assert (comp.graph_aggregate.__self__
                is registry.get_backend("reference"))
        assert comp.name == "composite(reference; dense_matmul=cuda)"
        with pytest.raises(ValueError):
            registry.composite_backend("reference", {"nope": "cuda"})

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError):
            registry.get_backend("fpga")
        with pytest.raises(ValueError):
            registry.resolve("fpga")


def test_composite_name_matches_reference_format():
    jreg = pytest.importorskip("repro.kernels.registry")
    per_op = {"gather_aggregate": "reference", "attention": "reference"}
    assert registry.composite_backend("reference", per_op).name == \
        jreg.composite_backend("reference", per_op).name


def test_register_list_and_alias(counting):
    assert "counting" in registry.list_backends()
    assert registry.get_backend("cnt") is counting
    assert isinstance(counting, registry.KernelBackend)
    for name in registry.list_backends():
        for op in registry.OP_NAMES:
            assert callable(getattr(registry.get_backend(name), op))
    assert runtime.get_backend is registry.get_backend
    assert runtime.register_backend is registry.register_backend
    assert runtime.list_backends is registry.list_backends
    assert runtime.KernelBackend is registry.KernelBackend


def test_engines_and_ops_resolve_per_op_at_call_time(monkeypatch, counting):
    """An engine with ``backend=None`` reads the variables at each call,
    as the reference's engines do; so do the ``kernels.ops`` entries."""
    x, w = torch.randn(6, 4), torch.randn(4, 3)
    dense = DenseEngine()
    dense(x, w)
    assert counting.calls == {}
    monkeypatch.setenv("REPRO_KERNEL_BACKEND_DENSE_MATMUL", "counting")
    torch.testing.assert_close(dense(x, w), x @ w)
    ops.dense_matmul(x, w)
    assert counting.calls == {"dense_matmul": 2}
    monkeypatch.delenv("REPRO_KERNEL_BACKEND_DENSE_MATMUL")
    dense(x, w)
    assert counting.calls == {"dense_matmul": 2}
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "counting")
    blocks = (torch.rand(2, 2, 4, 4) < 0.5).float()
    GraphEngine().spmm(blocks, torch.randn(2, 4, 3))
    assert counting.calls == {"dense_matmul": 2, "graph_aggregate": 1}
    # a pinned engine ignores the variables
    DenseEngine(backend=registry.get_backend("cuda"))(x, w)
    assert counting.calls["dense_matmul"] == 2


# ---------------------------------------------------------------------------
# tests/test_runtime.py's per-op tests, through runtime.compile
# ---------------------------------------------------------------------------

def test_per_op_env_override_reaches_compile(monkeypatch):
    """REPRO_KERNEL_BACKEND_<OP> survives into the pinned Executable
    when no explicit backend is passed."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "reference")
    monkeypatch.setenv("REPRO_KERNEL_BACKEND_GATHER_AGGREGATE", "cuda")
    ds = _cora()
    exe = _compile("sage_max", ds)
    assert exe.backend.gather_aggregate.__self__ is \
        runtime.get_backend("cuda")
    assert exe.backend.dense_matmul.__self__ is \
        runtime.get_backend("reference")
    assert exe.backend_name == \
        "composite(reference; gather_aggregate=cuda)"
    # an explicit backend argument beats the per-op env override
    pinned = _compile("sage_max", ds, backend="reference")
    assert pinned.backend is runtime.get_backend("reference")
    torch.testing.assert_close(exe.forward(), pinned.forward(),
                               atol=1e-5, rtol=1e-5)


def test_op_backends_override(monkeypatch, counting):
    ds = _cora()
    exe = _compile("sage_max", ds, backend="reference",
                   op_backends={"gather_aggregate": "cnt"})
    assert exe.backend_name.startswith("composite(reference")
    ref_exe = _compile("sage_max", ds, backend="reference")
    torch.testing.assert_close(exe.forward(), ref_exe.forward(),
                               atol=1e-5, rtol=1e-5)
    assert counting.calls == {"gather_aggregate": 2}     # one per layer
    # explicit op_backends beat the per-op variable
    monkeypatch.setenv("REPRO_KERNEL_BACKEND_GATHER_AGGREGATE", "cuda")
    again = _compile("sage_max", ds, op_backends={"gather_aggregate": "cnt"})
    assert again.backend.gather_aggregate.__self__ is counting
    assert again.backend.dense_matmul.__self__ is runtime.get_backend("cuda")


def test_composite_over_graph_aggregate_indexed(counting):
    """gat's heads are the port-only op ``graph_aggregate_indexed``; a
    composite routes them alone."""
    ds = _cora()
    exe = _compile("gat", ds,
                   op_backends={"graph_aggregate_indexed": "counting"})
    assert exe.backend.graph_aggregate_indexed.__self__ is counting
    assert exe.backend.dense_matmul.__self__ is runtime.get_backend("cuda")
    plain = _compile("gat", ds, params=exe.params)
    torch.testing.assert_close(exe.forward(), plain.forward(),
                               atol=1e-6, rtol=1e-6)
    # 2 heads on layer 0, 1 on layer 1; nothing else asked the counter
    assert counting.calls == {"graph_aggregate_indexed": 3}


def test_composite_compile_tunes_and_memoizes_under_its_own_key(
        monkeypatch):
    """The tune scope and ``summary()`` take the composite's name, so a
    composite compile never reads a plain compile's winner."""
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    tune.clear_tune_cache()
    try:
        comp = registry.composite_backend(
            "cuda", {"gather_aggregate": "reference"})
        assert tune.tune_scope(comp.name, CPU) != \
            tune.tune_scope("cuda", CPU)
        ds = make_dataset("cora", seed=0, scale=0.02)
        kw = dict(plan="autotune", tune_budget=2, tune_reps=1,
                  max_shard_n=16)
        plain = runtime.compile(_spec("sage_max", ds), ds, device=CPU,
                                store=runtime.GraphStore(), **kw)
        n_plain = runtime.tune_cache_stats()["measurements"]
        assert n_plain > 0
        exe = runtime.compile(_spec("sage_max", ds), ds, device=CPU,
                              store=runtime.GraphStore(),
                              op_backends={"gather_aggregate": "reference"},
                              **kw)
        stats = runtime.tune_cache_stats()
        assert stats["misses"] == 2 and stats["measurements"] > n_plain
        assert exe.plan_source == plain.plan_source == "autotune"
        assert f"backend={comp.name}" in exe.summary()
        assert "backend=cuda " in plain.summary()
    finally:
        tune.clear_tune_cache()


def test_op_backends_names_an_unknown_op_or_backend():
    ds = _cora()
    with pytest.raises(ValueError, match="unknown op"):
        _compile("gcn", ds, op_backends={"spmm": "reference"})
    with pytest.raises(ValueError, match="unknown kernel backend"):
        _compile("gcn", ds, op_backends={"dense_matmul": "fpga"})


def test_attention_reads_its_variable(monkeypatch, counting):
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm

    cfg = get_smoke("qwen3-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32))
    base = lm.forward(params, cfg, {"tokens": toks})
    monkeypatch.setenv("REPRO_KERNEL_BACKEND_ATTENTION", "counting")
    torch.testing.assert_close(lm.forward(params, cfg, {"tokens": toks}),
                               base)
    assert counting.calls == {"attention": cfg.n_layers}
