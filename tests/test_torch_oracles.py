"""The port's dense-adjacency layer oracles (``kernels/ref.py``) against
the reference's (``repro.kernels.ref``), and the port's compiled zoo
forwards against both.

Each oracle gets the same numpy inputs on both sides: a random weighted
adjacency with empty rows (a destination with no neighbor takes the
reference's identity), flat features and parameters; float32 within
atol = rtol = 1e-5. The max-pool and gat oracles take destination rows
in chunks of ``ref.ORACLE_CHUNK_BYTES``; a small budget must give the
unchunked result bit for bit. Last, ``runtime.compile(...).forward`` on
the ``reference`` backend is held to the port's oracles (through
``chip_smoke.py``'s ``_oracle_logits``, what phase 4i holds the card's
forwards to) and to the reference's own ``_ref_forward``
(tests/test_gnn_models.py) on the same numpy parameters, for the five
archs on scaled Cora and Citeseer
with shard grids of S > 1, within the reference's 5e-5.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import runtime
from repro_torch.gnn.models import ARCHS, ZooSpec, init_params
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import ref
from test_gnn_models import _ref_forward

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=5e-5, rtol=5e-5)
N, D, F, HEADS = 40, 12, 6, 2


def _adjacency(seed: int = 0) -> np.ndarray:
    """(N, N) float32: ~15% of entries positive weights, rows 3 and 17 and
    the last two rows empty, row-normalized like a mean aggregator."""
    r = np.random.default_rng(seed)
    a = (r.random((N, N)) < 0.15) * r.uniform(0.1, 1.0, (N, N))
    a[[3, 17, N - 2, N - 1]] = 0.0
    rows = a.sum(1, keepdims=True)
    return (a / np.where(rows > 0, rows, 1.0)).astype(np.float32)


def _arrays(seed: int, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _both(fn_name, np_args, kwargs=None):
    """The port's and the reference's oracle on the same numpy arrays."""
    kwargs = kwargs or {}
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in np_args]
    j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in np_args]
    got = getattr(ref, fn_name)(*t_args, **kwargs)
    exp = getattr(jref, fn_name)(*j_args, **kwargs)
    return got.numpy(), np.asarray(exp)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_gcn_layer(act):
    h, w = _arrays(1, (N, D), (D, F))
    got, exp = _both("gcn_layer", [_adjacency(), h, w], {"activation": act})
    np.testing.assert_allclose(got, exp, **TOL)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_sage_mean_layer(act):
    h, w = _arrays(2, (N, D), (2 * D, F))
    got, exp = _both("sage_mean_layer", [_adjacency(), h, w],
                     {"activation": act})
    np.testing.assert_allclose(got, exp, **TOL)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_sage_max_pool_layer(act):
    h, w_pool, b_pool, w = _arrays(3, (N, D), (D, D), (D,), (2 * D, F))
    got, exp = _both("sage_max_pool_layer",
                     [_adjacency(), h, w_pool, b_pool, w],
                     {"activation": act})
    np.testing.assert_allclose(got, exp, **TOL)
    # an empty row's pooled neighbor term is 0: only h's half remains
    z_empty = torch.cat([torch.zeros(D), torch.from_numpy(h[3])]) @ \
        torch.from_numpy(w)
    if act == "relu":
        z_empty = torch.relu(z_empty)
    np.testing.assert_allclose(got[3], z_empty.numpy(), **TOL)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_gin_layer(act):
    h, w1, b1, w2, b2 = _arrays(4, (N, D), (D, F), (F,), (F, F), (F,))
    eps = np.float32(0.25)
    got, exp = _both("gin_layer", [_adjacency(), h, eps, w1, b1, w2, b2],
                     {"activation": act})
    np.testing.assert_allclose(got, exp, **TOL)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_gat_layer(concat, act):
    h, w, a_src, a_dst = _arrays(5, (N, D), (D, HEADS * F), (HEADS, F),
                                 (HEADS, F))
    got, exp = _both("gat_layer", [_adjacency(), h, w, a_src, a_dst],
                     {"activation": act, "concat_heads": concat})
    np.testing.assert_allclose(got, exp, **TOL)
    assert not got[[3, 17]].any()           # no neighbor: α = 0


def _pool_args():
    h, w_pool, b_pool, w = _arrays(3, (N, D), (D, D), (D,), (2 * D, F))
    return ("sage_max_pool_layer", N * D * 4,
            [torch.from_numpy(a) for a in (_adjacency(), h, w_pool, b_pool,
                                           w)])


def _gat_args():
    h, w, a_src, a_dst = _arrays(5, (N, D), (D, HEADS * F), (HEADS, F),
                                 (HEADS, F))
    return ("gat_layer", N * HEADS * F * 4,
            [torch.from_numpy(a) for a in (_adjacency(), h, w, a_src,
                                           a_dst)])


@pytest.mark.parametrize("args", [_pool_args, _gat_args],
                         ids=["sage_max_pool", "gat"])
@pytest.mark.parametrize("rows", [1, 3, 7])
def test_chunked_rows_are_bitwise_unchunked(monkeypatch, args, rows):
    name, row_bytes, inputs = args()
    fn = getattr(ref, name)
    whole = fn(*inputs, activation="relu")
    monkeypatch.setattr(ref, "ORACLE_CHUNK_BYTES", rows * row_bytes)
    assert len(ref._row_chunks(N, row_bytes)) == -(-N // rows)
    assert torch.equal(fn(*inputs, activation="relu"), whole)


def _flat_adj(blocks: torch.Tensor) -> torch.Tensor:
    s, _, n, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(s * n, s * n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dataset", ["cora", "citeseer"])
def test_compiled_forward_matches_oracles(arch, dataset):
    ds = make_dataset(dataset, seed=1, scale=0.08)
    prof = ds.profile
    dims = (prof.feature_dim, 8, prof.num_classes)
    spec = ZooSpec(arch, *dims, num_layers=2, heads=2)
    params = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    np_layers = [{k: v.numpy() for k, v in layer.items()}
                 for layer in params["layers"]]
    exe = runtime.compile(spec, ds,
                          device="cpu", backend="reference", params=params,
                          max_shard_n=64, store=runtime.GraphStore())
    assert exe.plan.layers[0].S > 1, "must exercise a multi-shard grid"
    out = exe.forward().numpy()

    # the oracle forward chip_smoke.py holds the card's forwards to
    port = _chip_smoke()._oracle_logits(arch, params["layers"], exe.gt,
                                        torch.from_numpy(ds.features))
    np.testing.assert_allclose(out, port.numpy(), **FWD_TOL)
    a = _flat_adj(exe.gt.blocks)
    h = torch.zeros((a.shape[0], prof.feature_dim))
    h[:prof.num_nodes] = torch.from_numpy(ds.features)
    exp = np.asarray(_ref_forward(arch, np_layers,
                                  jnp.asarray(a.numpy()),
                                  jnp.asarray(h.numpy())))[:prof.num_nodes]
    np.testing.assert_allclose(out, exp, **FWD_TOL)
