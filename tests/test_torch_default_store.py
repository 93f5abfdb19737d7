"""``runtime.compile(store=None)`` builds through the module-wide
``default_store()``, as the reference's compile does: standalone compiles
of one graph share one build per signature, until ``evict()``."""
import pytest
import torch

from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.runtime import cache
from repro_torch.runtime.cache import compile_counts

CPU = torch.device("cpu")


@pytest.fixture
def store():
    """The default store, empty before and after the test."""
    s = runtime.default_store()
    s.evict()
    yield s
    s.evict()


def _setup(arch="gcn"):
    ds = make_dataset("cora", seed=0, scale=0.05)
    return ds, ZooSpec(arch, ds.profile.feature_dim, 8,
                       ds.profile.num_classes)


def test_default_store_is_module_wide():
    assert runtime.default_store() is cache.default_store() is \
        cache._DEFAULT_STORE
    assert isinstance(runtime.default_store(), runtime.GraphStore)
    assert runtime.default_store().max_entries == 8


def test_two_standalone_compiles_share_gt(store):
    ds, spec = _setup()
    before = compile_counts()["graph_builds"]
    e1 = runtime.compile(spec, ds, device=CPU, max_shard_n=64)
    e2 = runtime.compile(spec, ds, device=CPU, max_shard_n=64, seed=1)
    assert e1.gt is e2.gt
    assert len(store) == 1
    assert store.stats["misses"] >= 1 and store.stats["hits"] >= 1
    assert compile_counts()["graph_builds"] - before == 1
    # another signature is another build; the entry key names the device
    e3 = runtime.compile(_setup("sage_mean")[1], ds, device=CPU,
                         max_shard_n=64)
    assert e3.gt is not e1.gt and len(store) == 2
    assert all(key[-1] == "cpu" for key in store._entries)
    # an explicit store stays private
    e4 = runtime.compile(spec, ds, device=CPU, max_shard_n=64,
                         store=runtime.GraphStore())
    assert e4.gt is not e1.gt and len(store) == 2


def test_evict_empties_the_default_store(store):
    ds, spec = _setup()
    e1 = runtime.compile(spec, ds, device=CPU, max_shard_n=64)
    assert len(store) == 1
    store.evict()
    assert len(store) == 0
    # the Executable keeps its own tensors; the next compile rebuilds
    torch.testing.assert_close(e1.forward(), e1.forward())
    e2 = runtime.compile(spec, ds, device=CPU, max_shard_n=64)
    assert e2.gt is not e1.gt and len(store) == 1
    torch.testing.assert_close(e2.forward(), e1.forward())


def test_fit_without_a_store_shares_the_compile_build(store):
    ds, spec = _setup()
    exe = runtime.compile(spec, ds, device=CPU, max_shard_n=64)
    res = runtime.fit(spec, ds, steps=2, device=CPU, max_shard_n=64,
                      log=lambda _line: None)
    assert res.executable.gt is exe.gt and len(store) == 1
