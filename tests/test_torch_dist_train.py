"""Data-parallel training on a ``LocalMesh`` (``runtime.fit(mesh=...)``).

The loss enters once per data group, autograd runs the collectives'
transposes, and the replicated parameters' gradients are summed over the
mesh, so a sharded step's gradients are the single-device step's — held
here to ``jax.grad`` of the reference's single-device forward on the same
numpy parameters, and a 3-step sharded fit to a 3-step single-device fit
of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import runtime as jax_runtime
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.runtime.fit import masked_cross_entropy as jax_ce
from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.runtime.executable import _flatten_params

GRAD_REL = 1e-4
QUIET = dict(log=lambda s: None)


def _mesh(n_data=4, n_model=2):
    return make_mesh_for(n_data * n_model, model_parallel=n_model,
                         device="cpu")


@pytest.fixture(scope="module")
def cora_half():
    return make_dataset("cora", seed=0, scale=0.5)


def _jax_grads(spec, ds, params):
    exe = jax_runtime.compile(spec, ds, backend="reference", max_shard_n=128,
                              params=params)
    fwd = exe._forward_fn()
    labels = jnp.asarray(ds.labels.astype(np.int32))
    mask = jnp.asarray(ds.train_mask)
    grads = jax.grad(lambda p: jax_ce(fwd(p, exe._h_grouped), labels,
                                      mask))(exe.params)
    return jax.tree_util.tree_map(np.asarray, grads)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
@pytest.mark.parametrize("arch", ["gcn", "sage_mean", "gin"])
def test_step0_grads_match_jax_single_device(cora_half, arch, partition):
    prof = cora_half.profile
    jspec = JaxSpec(arch, prof.feature_dim, 8, prof.num_classes)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_zoo(jax.random.key(5), jspec))
    expect = _flatten_params(_jax_grads(jspec, cora_half, params))
    exe = runtime.compile(ZooSpec(arch, prof.feature_dim, 8,
                                  prof.num_classes), cora_half,
                          device="cpu", backend="reference", max_shard_n=128,
                          params=params, mesh=_mesh(), partition=partition,
                          hub_cache=64)
    tr = runtime.TrainableExecutable(exe, cora_half.labels,
                                     train_mask=cora_half.train_mask)
    _, _, grads = tr.loss_and_grads(tr.params, tr.data(0))
    got = _flatten_params(grads)
    assert got.keys() == expect.keys()
    rels = {k: _rel(got[k], expect[k]) for k in expect}
    assert max(rels.values()) <= GRAD_REL, rels
    assert all(np.linalg.norm(v) > 0 for v in expect.values())


def test_sharded_fit_matches_single_device_fit():
    ds = make_dataset("cora", seed=0, scale=0.3)
    spec = ZooSpec("gcn", ds.profile.feature_dim, 8, ds.profile.num_classes)
    kw = dict(steps=3, lr=1e-2, device="cpu", backend="reference",
              max_shard_n=128, **QUIET)
    single = runtime.fit(spec, ds, **kw)
    sharded = runtime.fit(spec, ds, mesh=_mesh(), **kw)
    a, b = _flatten_params(single.params), _flatten_params(sharded.params)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([loss for _, loss in sharded.history],
                               [loss for _, loss in single.history],
                               rtol=1e-5)
    # the trained sharded executable serves the trained weights
    np.testing.assert_allclose(sharded.executable.forward().numpy(),
                               single.executable.forward().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
def test_train_step_collectives_verified(partition):
    """One train step's counted collectives: at least the forward
    all-gather volume, the all-gathers' transposes (reduce-scatter) and
    the gradient all-reduce over the whole mesh, one per parameter."""
    ds = make_dataset("cora", seed=0, scale=0.3)
    spec = ZooSpec("gcn", ds.profile.feature_dim, 8, ds.profile.num_classes)
    mesh = _mesh()
    res = runtime.fit(spec, ds, steps=1, device="cpu", backend="reference",
                      max_shard_n=128, mesh=mesh, partition=partition,
                      hub_cache=64, **QUIET)
    cs = res.trainable.verify_train_comm()
    fwd = res.executable.comm_stats()
    assert cs["measured_wire_bytes"]["all-gather"] == \
        cs["forward_allgather_wire_bytes"] == \
        fwd["measured_allgather_wire_bytes"]
    counts = cs["measured_counts"]
    # layer 0's all-gather carries the input, which has no gradient
    assert counts["reduce-scatter"] == fwd["measured_counts"][
        "all-gather"] - (0 if partition == "fennel" else 1)
    n_leaves = len(_flatten_params(res.params))
    assert counts["all-reduce"] == 2 * fwd["measured_counts"][
        "all-reduce"] + n_leaves
    with mesh.comm.capture() as log:
        res.trainable.loss_and_grads(res.trainable.params,
                                     res.trainable.data(0))
    world = [e for e in log.entries if e.axis == "world"]
    assert len(world) == n_leaves and all(e.group == 8 for e in world)


def test_minibatch_on_a_mesh_raises():
    ds = make_dataset("cora", seed=0, scale=0.2)
    spec = ZooSpec("gcn", ds.profile.feature_dim, 8, ds.profile.num_classes)
    with pytest.raises(NotImplementedError, match="mini-batch"):
        runtime.fit(spec, ds, steps=1, device="cpu", backend="reference",
                    max_shard_n=64, mesh=_mesh(2, 1), batch_nodes=8,
                    fanout=(2,), **QUIET)
