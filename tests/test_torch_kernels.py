"""The port's kernels against the reference package's Pallas kernels.

On the CPU each plain PyTorch version (``repro_torch.kernels.ref``, which
the kernel wrappers run for CPU tensors) is held to the Pallas kernel in
interpret mode at the shapes of tests/test_kernels.py, on the same numpy
inputs. The ``cuda``-marked tests hold each CUDA kernel to its plain
version on the card and skip without one.

The reference package is imported inside a fixture, not at module level:
the machine with the card has no JAX, and the ``cuda`` tests of this file
must still import there.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels import dense_engine as t_dense
from repro_torch.kernels import fused_gnn as t_fused
from repro_torch.kernels import seg_gather as t_gather
from repro_torch.kernels import shard_spmm as t_spmm

TOL = dict(atol=1e-4, rtol=1e-4)   # float32 products, as tests/test_kernels.py


@pytest.fixture
def jx():
    """The reference package's Pallas kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels import registry
    from repro.kernels.dense_engine import dense_engine_matmul
    from repro.kernels.fused_gnn import fused_gnn_layer
    from repro.kernels.seg_gather import seg_gather_aggregate
    from repro.kernels.shard_spmm import shard_spmm
    return types.SimpleNamespace(
        dense=dense_engine_matmul, fused=fused_gnn_layer,
        gather=seg_gather_aggregate, spmm=shard_spmm,
        pallas=registry.get_backend("pallas"))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(r, s_dst, s_src, n, e):
    es = r.integers(0, n, (s_dst, s_src, e)).astype(np.int32)
    ed = r.integers(0, n, (s_dst, s_src, e)).astype(np.int32)
    ev = r.random((s_dst, s_src, e)) < 0.6
    return es, ed, ev


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (64, 64, 64, 32, 32, 32),
    (128, 256, 64, 64, 64, 64),
    (32, 96, 160, 32, 32, 32),
])
def test_dense_engine_matches_pallas(jx, m, k, n, bm, bk, bn):
    r = _rng(m + k + n)
    x, w = r.standard_normal((m, k), np.float32), r.standard_normal((k, n), np.float32)
    b = r.standard_normal((n,), np.float32)
    exp = jx.dense(x, w, b, activation="relu", bm=bm, bn=bn, bk=bk,
                   interpret=True)
    out = t_dense.dense_engine_matmul(_t(x), _t(w), _t(b), activation="relu")
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_dense_engine_activations_match_pallas(jx, activation):
    """gelu is the tanh approximation on both sides (jax.nn.gelu's default)."""
    r = _rng(7)
    x, w = r.standard_normal((64, 96), np.float32), r.standard_normal((96, 32), np.float32)
    b = r.standard_normal((32,), np.float32)
    exp = jx.dense(x, w, b, activation=activation, bm=32, bn=32, bk=32,
                   interpret=True)
    out = ref.dense_engine(_t(x), _t(w), _t(b), activation=activation)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_dense_engine_without_bias_matches_pallas(jx):
    r = _rng(8)
    x, w = r.standard_normal((32, 64), np.float32), r.standard_normal((64, 32), np.float32)
    exp = jx.dense(x, w, None, bm=32, bn=32, bk=32, interpret=True)
    out = t_dense.dense_engine_matmul(_t(x), _t(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("s,n,d,bb", [(2, 16, 32, 16), (4, 8, 64, 32), (3, 32, 48, 16)])
def test_shard_spmm_matches_pallas(jx, s, n, d, bb):
    r = _rng(s * 100 + n + d)
    a = (r.random((s, s, n, n)) < 0.2).astype(np.float32)
    h = r.standard_normal((s, n, d), np.float32)
    exp = jx.spmm(a, h, block_b=bb, interpret=True)
    out = t_spmm.shard_spmm(_t(a), _t(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_shard_spmm_ragged_d_matches_pallas_backend_padding(jx):
    """D = 40 is no multiple of the block: the reference backend pads it."""
    r = _rng(11)
    a = (r.random((3, 3, 16, 16)) < 0.3).astype(np.float32)
    h = r.standard_normal((3, 16, 40), np.float32)
    exp = jx.pallas.graph_aggregate(a, h, block_b=16)
    out = t_spmm.shard_spmm(_t(a), _t(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_shard_spmm_rectangular_grid_matches_pallas(jx):
    r = _rng(12)
    a = (r.random((2, 3, 8, 8)) < 0.3).astype(np.float32)   # S_dst=2, S_src=3
    h = r.standard_normal((3, 8, 32), np.float32)
    exp = jx.spmm(a, h, block_b=16, interpret=True)
    out = t_spmm.shard_spmm(_t(a), _t(h))
    assert out.shape == (2, 8, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("s,n,d,f,bb", [(2, 16, 32, 8, 16), (3, 8, 64, 24, 16)])
def test_fused_gnn_matches_pallas(jx, s, n, d, f, bb):
    r = _rng(s + n + d + f)
    a = (r.random((s, s, n, n)) < 0.2).astype(np.float32)
    h = r.standard_normal((s, n, d), np.float32)
    w = r.standard_normal((d, f), np.float32)
    exp = jx.fused(a, h, w, block_b=bb, activation="relu", interpret=True)
    out = t_fused.fused_gnn_layer(_t(a), _t(h), _t(w), activation="relu")
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_fused_gnn_ragged_d_matches_pallas_backend_padding(jx):
    r = _rng(13)
    a = (r.random((2, 2, 16, 16)) < 0.3).astype(np.float32)
    h = r.standard_normal((2, 16, 40), np.float32)
    w = r.standard_normal((40, 5), np.float32)
    exp = jx.pallas.fused_aggregate_extract(
        a, h, w, activation="gelu", block_b=16)
    out = t_fused.fused_gnn_layer(_t(a), _t(h), _t(w), activation="gelu")
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("s,n,e,d,bb", [(2, 16, 24, 32, 16), (3, 8, 40, 16, 16)])
def test_seg_gather_matches_pallas(jx, op, s, n, e, d, bb):
    r = _rng(s + n + e + d)
    es, ed, ev = _edges(r, s, s, n, e)
    h = r.standard_normal((s, n, d), np.float32)
    exp = jx.gather(es, ed, ev, h, op=op, block_b=bb, interpret=True)
    out = t_gather.seg_gather_aggregate(_t(es), _t(ed), _t(ev), _t(h), op=op)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("op", ["max", "sum"])
def test_seg_gather_empty_destination_is_zero(jx, op):
    """Destination 0 of every shard has no in-edge: both sides write 0
    there (the TPU kernel's -3e38 identity, the plain version's -inf)."""
    r = _rng(14)
    es, ed, ev = _edges(r, 2, 2, 8, 16)
    ed = np.maximum(ed, 1)
    h = r.standard_normal((2, 8, 24), np.float32) - 5.0   # all negative
    exp = np.asarray(jx.pallas.gather_aggregate(
        es, ed, ev, h, op=op, block_b=16))
    out = t_gather.seg_gather_aggregate(_t(es), _t(ed), _t(ev), _t(h),
                                        op=op).numpy()
    assert (out[:, 0] == 0).all() and (exp[:, 0] == 0).all()
    np.testing.assert_allclose(out, exp, **TOL)


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    """Only CPU tensors take the plain version; a tensor elsewhere (here a
    meta tensor) raises rather than quietly running some other path."""
    a = torch.empty((1, 1, 4, 4), device="meta")
    h = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="devices"):
        t_spmm.shard_spmm(a, h)
    with pytest.raises(ValueError, match="devices"):
        t_spmm.shard_spmm(torch.zeros((1, 1, 4, 4)), h)


def test_plain_path_does_not_count_launches():
    _lib.reset_launches()
    r = _rng(15)
    t_dense.dense_engine_matmul(_t(r.standard_normal((4, 4), np.float32)),
                                _t(r.standard_normal((4, 4), np.float32)))
    assert _lib.launches() == dict.fromkeys(_lib.KERNELS, 0)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version (ragged shapes)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counted(kernel, fn):
    before = _lib.launches()[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert _lib.launches()[kernel] == before + 1
    return out


def _blocks(r, shape, density):
    """Random 0/1 blocks; at low density most 64x16 slices are empty (the
    kernels skip those), and destination shard 0 has no edge at all."""
    a = (r.random(shape) < density).astype(np.float32)
    a[0] = 0.0
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.2, 0.003])
def test_cuda_shard_spmm_matches_plain(cuda, density):
    r = _rng(21)
    a = _t(_blocks(r, (2, 3, 70, 70), density)).to(cuda)
    h = _t(r.standard_normal((3, 70, 83), np.float32)).to(cuda)
    out = _counted("shard_spmm", lambda: t_spmm.shard_spmm(a, h))
    torch.testing.assert_close(out, ref.shard_spmm(a, h), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.2, 0.003])
def test_cuda_fused_gnn_matches_plain(cuda, density):
    r = _rng(22)
    a = _t(_blocks(r, (3, 3, 70, 70), density)).to(cuda)
    h = _t(r.standard_normal((3, 70, 150), np.float32)).to(cuda)
    for f in (3, 16, 77):   # 77 > one 64-wide F tile
        w = _t(r.standard_normal((150, f), np.float32)).to(cuda)
        out = _counted("fused_gnn", lambda: t_fused.fused_gnn_layer(
            a, h, w, activation="relu"))
        torch.testing.assert_close(
            out, ref.fused_gnn(a, h, w, activation="relu"), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_cuda_dense_engine_matches_plain(cuda, activation):
    r = _rng(23)
    x = _t(r.standard_normal((131, 75), np.float32)).to(cuda)
    w = _t(r.standard_normal((75, 67), np.float32)).to(cuda)
    b = _t(r.standard_normal((67,), np.float32)).to(cuda)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(
        x, w, b, activation=activation))
    torch.testing.assert_close(
        out, ref.dense_engine(x, w, b, activation=activation), **TOL)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(x, w))
    torch.testing.assert_close(out, ref.dense_engine(x, w), **TOL)


@pytest.mark.cuda
def test_cuda_dense_engine_propagates_nonfinite_like_plain(cuda):
    """dense_engine multiplies every K slice: a zero slice of x against
    Inf rows of w gives NaN, as in the plain product."""
    r = _rng(25)
    x = r.standard_normal((131, 75), np.float32)
    x[:, 16:32] = 0.0
    w = r.standard_normal((75, 67), np.float32)
    w[20, 5] = np.inf
    w[40, 9] = np.nan
    x, w = _t(x).to(cuda), _t(w).to(cuda)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(x, w))
    plain = ref.dense_engine(x, w)
    assert torch.isnan(plain[:, 5]).all() and torch.isnan(plain[:, 9]).all()
    torch.testing.assert_close(out, plain, equal_nan=True, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["max", "sum"])
def test_cuda_seg_gather_matches_plain(cuda, op):
    r = _rng(24)
    es, ed, ev = _edges(r, 2, 3, 40, 100)
    ed = np.maximum(ed, 1)              # destination 0: no in-edge
    es, ed, ev = (_t(x).to(cuda) for x in (es, ed, ev))
    h = _t(r.standard_normal((3, 40, 45), np.float32)).to(cuda)
    out = _counted("seg_gather", lambda: t_gather.seg_gather_aggregate(
        es, ed, ev, h, op=op))
    plain = ref.seg_gather(es, ed, ev, h, op=op)
    assert (out[:, 0] == 0).all()
    if op == "max":
        assert torch.equal(out, plain)
    else:
        torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)
