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

from repro_torch.kernels import _lib, csr, ops, ref
from repro_torch.kernels import dense_engine as t_dense
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import fused_gnn as t_fused
from repro_torch.kernels import seg_gather as t_gather
from repro_torch.kernels import shard_spmm as t_spmm

TOL = dict(atol=1e-4, rtol=1e-4)   # float32 products, as tests/test_kernels.py
# attention, as tests/test_kernels.py::test_flash_attention: float32
# inputs 2e-4; bfloat16 inputs 8e-2 (one bf16 rounding of outputs of
# magnitude up to ~4 is 1.6e-2 apart, plus the inputs' own rounding)
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
# and on the card, relative norm ||out - plain|| / ||plain|| (as
# chip_smoke.py): it weighs the small late causal rows that the max-abs
# limit, set by the first rows, cannot see
ATTN_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _assert_attention_close(out, plain, dtype):
    got, exp = out.float(), plain.float()
    torch.testing.assert_close(got, exp, atol=ATTN_TOL[dtype],
                               rtol=ATTN_TOL[dtype])
    rel = ((got - exp).norm() / exp.norm().clamp_min(1e-30)).item()
    assert rel <= ATTN_REL[dtype], f"relative norm error {rel:.3e}"


@pytest.fixture
def jx():
    """The reference package's Pallas kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels import registry
    from repro.kernels import ref as jref
    from repro.kernels.dense_engine import dense_engine_matmul
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.fused_gnn import fused_gnn_layer
    from repro.kernels.seg_gather import seg_gather_aggregate
    from repro.kernels.shard_spmm import shard_spmm
    return types.SimpleNamespace(
        dense=dense_engine_matmul, fused=fused_gnn_layer,
        gather=seg_gather_aggregate, spmm=shard_spmm, flash=flash_attention,
        ref=jref, pallas=registry.get_backend("pallas"))


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


@pytest.mark.parametrize("d,f,order", [
    (602, 16, t_fused.PROJECT_FIRST),    # reddit x0.1 layer 0
    (500, 16, t_fused.PROJECT_FIRST),    # Pubmed layer 0
    (16, 3, t_fused.PROJECT_FIRST),      # Pubmed layer 1
    (17, 16, t_fused.PROJECT_FIRST),
    (16, 41, t_fused.AGGREGATE_FIRST),   # reddit x0.1 layer 1
    (3, 16, t_fused.AGGREGATE_FIRST),
    (16, 16, t_fused.AGGREGATE_FIRST),   # D == F: the reference's order
    (1, 1, t_fused.AGGREGATE_FIRST),
])
def test_fused_gnn_route_aggregates_at_the_narrower_width(d, f, order):
    assert t_fused.route(d, f) == order


def test_fused_gnn_routes_count_launches_by_order(monkeypatch):
    """The wrapper's launch on a stand-in library: the order goes to the
    kernel as its last integer, the workspace holds Z (rows x F rounded
    up to 4) only when projecting first, and routes() counts each launch
    by order from zero until reset. The plain CPU version counts
    nothing."""
    r = _rng(14)
    a = _t((r.random((2, 2, 6, 6)) < 0.4).astype(np.float32))
    t_fused.reset_routes()
    assert t_fused.routes() == {t_fused.PROJECT_FIRST: 0,
                                t_fused.AGGREGATE_FIRST: 0}
    for d, f in ((7, 5), (5, 7)):
        t_fused.fused_gnn_layer(a, _t(r.standard_normal((2, 6, d), np.float32)),
                                _t(r.standard_normal((d, f), np.float32)))
    assert t_fused.routes() == {t_fused.PROJECT_FIRST: 0,
                                t_fused.AGGREGATE_FIRST: 0}
    calls = []
    monkeypatch.setattr(_lib, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_lib, "launch",
                        lambda kernel, *args, device: calls.append(args))
    for d, f in ((7, 5), (5, 7), (6, 6)):
        out = t_fused.fused_gnn_layer(
            a, _t(r.standard_normal((2, 6, d), np.float32)),
            _t(r.standard_normal((d, f), np.float32)))
        assert out.shape == (2, 6, f)
    assert [c[-1] for c in calls] == [1, 0, 0]
    assert [c[7].numel() for c in calls] == [12 * 8 + 4, 4, 4]
    assert t_fused.routes() == {t_fused.PROJECT_FIRST: 1,
                                t_fused.AGGREGATE_FIRST: 2}
    t_fused.reset_routes()
    assert t_fused.routes() == {t_fused.PROJECT_FIRST: 0,
                                t_fused.AGGREGATE_FIRST: 0}


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


def _qkv(r, b, hq, hkv, sq, skv, dh):
    return (r.standard_normal((b, hq, sq, dh)).astype(np.float32),
            r.standard_normal((b, hkv, skv, dh)).astype(np.float32),
            r.standard_normal((b, hkv, skv, dh)).astype(np.float32))


def _jax_dtype(dtype):
    import jax.numpy as jnp
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,window", [
    (1, 4, 4, 64, 64, 32, None),
    (2, 4, 2, 64, 64, 32, None),     # GQA
    (1, 2, 1, 32, 128, 16, None),    # cross lengths (q suffix of kv)
    (1, 4, 4, 128, 128, 32, 48),     # local window
    (1, 4, 1, 128, 128, 256, 48),    # MQA, dh 256, window (recurrentgemma)
])
def test_flash_attention_matches_pallas(jx, dtype, b, hq, hkv, sq, skv, dh,
                                        window):
    """The cases of tests/test_kernels.py::test_flash_attention; both sides
    get the same inputs rounded to ``dtype``."""
    import jax.numpy as jnp
    q, k, v = _qkv(_rng(sq + skv + dh), b, hq, hkv, sq, skv, dh)
    jd = _jax_dtype(dtype)
    exp = jx.flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   causal=True, window=window, bq=32, bk=32, interpret=True)
    out = t_flash.flash_attention(_t(q).to(dtype), _t(k).to(dtype),
                                  _t(v).to(dtype), causal=True, window=window)
    assert out.dtype == dtype
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,window", [
    (2, 4, 2, 70, 70, 16, None),     # ragged: no multiple of 64 (or 32)
    (1, 6, 3, 37, 100, 24, None),    # ragged, q suffix of kv
    (1, 4, 2, 70, 70, 16, 16),       # ragged window
    (1, 2, 1, 80, 50, 16, None),     # Sq > Skv: early rows see no key
])
def test_flash_attention_ragged_matches_reference_oracle(
        jx, causal, b, hq, hkv, sq, skv, dh, window):
    """Lengths the Pallas kernel cannot take (the reference backend falls
    back to its oracle there): the plain version against that oracle."""
    q, k, v = _qkv(_rng(sq * skv + dh), b, hq, hkv, sq, skv, dh)
    exp = np.asarray(jx.ref.flash_attention(q, k, v, causal=causal,
                                            window=window))
    out = t_flash.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_allclose(out, exp, atol=2e-4, rtol=2e-4)
    if causal and sq > skv:          # rows with no key left are 0 on both
        assert (out[:, :, :sq - skv] == 0).all()
        assert (exp[:, :, :sq - skv] == 0).all()


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_attention_op_dispatches_to_both_backends(backend):
    r = _rng(16)
    q, k, v = (_t(a) for a in _qkv(r, 1, 4, 2, 20, 20, 8))
    out = ops.attention(q, k, v, window=5, backend=backend)
    torch.testing.assert_close(
        out, ref.flash_attention(q, k, v, window=5), atol=0, rtol=0)


@pytest.mark.parametrize("dtype,dh,kernel", [
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.bfloat16, 128, "flash_attention_tc"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.bfloat16, 80, "flash_attention"),
    (torch.bfloat16, 16, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.bfloat16, 256, "flash_attention_tc"),  # recurrentgemma's
    (torch.bfloat16, 200, "flash_attention"),
    (torch.bfloat16, 255, "flash_attention"),
    (torch.float32, 256, "flash_attention"),
    (torch.float16, 128, "flash_attention"),   # refused there, by dtype
])
def test_flash_attention_route_is_static_by_dtype_and_head_dim(dtype, dh,
                                                               kernel):
    """bfloat16 at dh 64, 128 or 256 takes the tensor-core kernel,
    everything else the CUDA-core kernel; both are launch counters of
    their own."""
    assert t_flash._route(dtype, dh) == kernel
    assert kernel in _lib.KERNELS


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 200),
                                      (torch.float32, 256)])
def test_tensor_core_kernel_refuses_what_it_does_not_take(dtype, dh):
    """Forcing the tensor-core kernel onto a head dim or dtype outside its
    route raises before any launch (meta tensors: nothing can run)."""
    q, k, v = (torch.empty((1, 2, 8, dh), dtype=dtype, device="meta")
               for _ in range(3))
    with pytest.raises(ValueError, match="flash_attention_tc: takes"):
        t_flash._launch("flash_attention_tc", q, k, v)


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
    """Random 0/1 blocks; at low density most rows are empty or short,
    and destination shard 0 has no edge at all."""
    a = (r.random(shape) < density).astype(np.float32)
    a[0] = 0.0
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.2, 0.003])
@pytest.mark.parametrize("d", [3, 16, 83, 500, 700])
def test_cuda_shard_spmm_matches_plain(cuda, density, d):
    """With the blocks' kept index and standalone, on a square (3 x 3) and
    a rectangular (2 x 3) grid, at D 3 (odd, several rows a warp), 16,
    83 (odd), 500 (Pubmed, float4) and 700 (two D chunks), with empty
    rows (destination shard 0) and a hub row of 120 or more entries (row
    1 of shard 1); at density 0.2 most rows of shard 1 are hubs too."""
    r = _rng(21 + d)
    n = 70
    h = _t(r.standard_normal((3, n, d), np.float32)).to(cuda)
    for s_dst in (3, 2):
        a = _blocks(r, (s_dst, 3, n, n), density)
        a[1, :, 1, :40] = 1.0
        a = _t(a).to(cuda)
        index = csr.linear_index(a)
        counts = (index.row_ptr[1:] - index.row_ptr[:-1]).cpu()
        assert (counts[:n] == 0).all() and counts[n + 1] >= 3 * 40
        assert n + 1 in index.hubs.tolist()
        plain = ref.shard_spmm(a, h)
        torch.testing.assert_close(ref.spmm_indexed(index, h), plain, **TOL)
        for idx in (index, None):
            out = _counted("shard_spmm", lambda: t_spmm.shard_spmm(
                a, h, index=idx))
            assert out.shape == (s_dst, n, d)
            torch.testing.assert_close(out, plain, **TOL)


def _inf_behind_a_zero(device):
    """Blocks (2, 2, 4, 4) and h (2, 4, 3) where source row 5 (shard 1,
    node 1) holds +Inf in every column and no destination takes it: its
    column of the blocks is zero. Destination rows 0 and 4 have entries
    elsewhere; the dense product multiplies the Inf by those zeros."""
    r = _rng(41)
    a = (r.random((2, 2, 4, 4)) < 0.5).astype(np.float32)
    a[:, :, 0, 0] = 1.0
    a[:, 1, :, 1] = 0.0
    h = r.standard_normal((2, 4, 3)).astype(np.float32)
    h[1, 1] = np.inf
    return _t(a).to(device), _t(h).to(device)


def test_plain_spmm_gives_nan_for_inf_behind_a_zero():
    """The plain versions (dense products: 0 · Inf = NaN in every row of
    the destination shards) and so the wrappers' CPU routes give NaN; the
    index walk, as the kernels read, skips the zeros and stays finite.
    The ``cuda`` pin below holds the card to the walk."""
    a, h = _inf_behind_a_zero("cpu")
    w = torch.ones((3, 2))
    index = csr.linear_index(a)
    for out in (ref.shard_spmm(a, h), t_spmm.shard_spmm(a, h, index=index),
                ref.fused_gnn(a, h, w),
                t_fused.fused_gnn_layer(a, h, w, index=index)):
        assert torch.isnan(out).all()
    for out in (ref.spmm_indexed(index, h),
                ref.fused_gnn_indexed(index, h, w)):
        assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_cuda_spmm_is_finite_for_inf_behind_a_zero(cuda):
    """The stated divergence (``kernels/shard_spmm.py``,
    ``kernels/fused_gnn.py``): the kernels read only the blocks'
    nonzeros, so an Inf that only zeros of the blocks reach gives finite
    rows on the card, equal to the index walk, where the plain version
    gives NaN."""
    a, h = _inf_behind_a_zero(cuda)
    w = torch.ones((3, 2), device=cuda)
    index = csr.linear_index(a)
    assert torch.isnan(ref.shard_spmm(a, h)).all()
    for idx in (index, None):
        out = _counted("shard_spmm", lambda: t_spmm.shard_spmm(
            a, h, index=idx))
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref.spmm_indexed(index, h), **TOL)
        out = _counted("fused_gnn", lambda: t_fused.fused_gnn_layer(
            a, h, w, index=idx))
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref.fused_gnn_indexed(index, h, w),
                                   **TOL)


def test_shard_spmm_indexed_on_the_cpu_walks_the_index():
    """gat's aggregation takes the index as the truth: its values, not
    the blocks', weigh the rows (here twice the blocks' values)."""
    r = _rng(42)
    a = (r.random((2, 3, 5, 5)) < 0.4).astype(np.float32)
    h = _t(r.standard_normal((3, 5, 4), np.float32))
    index = csr.linear_index(_t(a))
    doubled = types.SimpleNamespace(**{**index.__dict__,
                                       "val": index.val * 2})
    out = t_spmm.shard_spmm_indexed(doubled, h)
    assert out.shape == (2, 5, 4)
    torch.testing.assert_close(out, 2 * ref.shard_spmm(_t(a), h), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16, 500])
def test_cuda_shard_spmm_indexed_matches_plain(cuda, d):
    """The kernel over an index whose values are not the blocks' (gat's
    α), at gat's widths (D 8: 16 hidden / 2 heads; D 3: the output
    layer), 16 and 500, with empty rows and a hub row; a strided h, and
    an h whose shards do not divide the index's rows, are refused."""
    r = _rng(43 + d)
    n = 70
    a = _blocks(r, (3, 3, n, n), 0.05)
    a[1, :, 1, :40] = 1.0
    index = csr.linear_index(_t(a).to(cuda))
    index = csr.LinearIndex(
        row_ptr=index.row_ptr, col=index.col, hubs=index.hubs,
        val=torch.rand(index.val.shape, device=cuda))
    h = _t(r.standard_normal((3, n, d), np.float32)).to(cuda)
    out = _counted("shard_spmm", lambda: t_spmm.shard_spmm_indexed(index, h))
    torch.testing.assert_close(out, ref.spmm_indexed(index, h), **TOL)
    wide = _t(r.standard_normal((3, n, 2 * d), np.float32)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_spmm.shard_spmm_indexed(index, wide[..., :d])
    with pytest.raises(ValueError, match="multiple"):
        t_spmm.shard_spmm_indexed(index, h[:, :40].contiguous())


@pytest.mark.cuda
def test_cuda_shard_spmm_reads_nothing_outside_a_bad_index(cuda):
    """An index not made by linear_index: a column past h and a last row
    pointer past the entry list. The kernel skips the column and stops at
    the list's end instead of reading out of range."""
    r = _rng(32)
    h = _t(r.standard_normal((2, 4, 8), np.float32)).to(cuda)
    a = torch.zeros((2, 2, 4, 4), device=cuda)
    bad = csr.LinearIndex(
        row_ptr=torch.tensor([0, 2, 2, 2, 2, 2, 2, 2, 9], dtype=torch.int32,
                             device=cuda),
        col=torch.tensor([3, 1000], dtype=torch.int32, device=cuda),
        val=torch.tensor([2.0, 1.0], device=cuda),
        hubs=torch.zeros(0, dtype=torch.int32, device=cuda))
    out = _counted("shard_spmm", lambda: t_spmm.shard_spmm(a, h, index=bad))
    expect = torch.zeros_like(out)
    expect[0, 0] = 2.0 * h.reshape(-1, 8)[3]
    torch.testing.assert_close(out, expect, **TOL)


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
@pytest.mark.parametrize("density", [0.2, 0.003])
@pytest.mark.parametrize("d", [3, 16, 150, 500, 600])
def test_cuda_fused_gnn_kept_index_and_hub_match_plain(cuda, density, d):
    """With the blocks' kept index and standalone, at D 3 and 16 (F 3
    projects first at D 16, F 16 and 77 aggregate first, D 3 on the
    scalar path), 150 (ragged), 500 (Pubmed) and 600, F 3, 16 and 77
    (several 16-column chunks), with empty rows (shard 0) and a hub row
    with nonzeros in every source shard."""
    r = _rng(30 + d)
    s, n = 3, 70
    a = _blocks(r, (s, s, n, n), density)
    a[1, :, 1, :40] = 0.25                 # the hub: row 1 of shard 1
    a = _t(a).to(cuda)
    h = _t(r.standard_normal((s, n, d), np.float32)).to(cuda)
    index = t_fused.linear_index(a)
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).cpu()
    assert (counts[:n] == 0).all() and counts.max() >= 3 * 40
    # rows of more than HUB_ENTRIES entries, longest first, get a warp
    # each: the hub, and at density 0.2 most rows of shards 1 and 2
    hubs = torch.nonzero(counts > csr.HUB_ENTRIES).reshape(-1)
    assert index.hubs.tolist() == hubs[torch.sort(
        counts[hubs], descending=True, stable=True)[1]].tolist()
    assert index.hubs[0] == n + 1
    for f in (3, 16, 77):
        w = _t(r.standard_normal((d, f), np.float32)).to(cuda)
        plain = ref.fused_gnn(a, h, w, activation="relu")
        torch.testing.assert_close(
            ref.fused_gnn_indexed(index, h, w, activation="relu"), plain,
            **TOL)
        for idx in (index, None):
            out = _counted("fused_gnn", lambda: t_fused.fused_gnn_layer(
                a, h, w, activation="relu", index=idx))
            torch.testing.assert_close(out, plain, **TOL)


@pytest.mark.cuda
def test_cuda_fused_gnn_reads_nothing_outside_a_bad_index(cuda):
    """An index not made by linear_index: a column past h and a last row
    pointer past the entry list. The kernel skips the column and stops at
    the list's end instead of reading out of range."""
    r = _rng(31)
    h = _t(r.standard_normal((2, 4, 8), np.float32)).to(cuda)
    w = torch.eye(8, device=cuda)
    a = torch.zeros((2, 2, 4, 4), device=cuda)
    bad = t_fused.LinearIndex(
        row_ptr=torch.tensor([0, 2, 2, 2, 2, 2, 2, 2, 9], dtype=torch.int32,
                             device=cuda),
        col=torch.tensor([3, 1000], dtype=torch.int32, device=cuda),
        val=torch.tensor([2.0, 1.0], device=cuda),
        hubs=torch.zeros(0, dtype=torch.int32, device=cuda))
    out = _counted("fused_gnn", lambda: t_fused.fused_gnn_layer(
        a, h, w, index=bad))
    expect = torch.zeros_like(out)
    expect[0, 0] = 2.0 * h.reshape(-1, 8)[3]
    torch.testing.assert_close(out, expect, **TOL)


def _power_law_blocks(r, s, n):
    """(s, s, n, n) blocks on which nearly every row is a hub: row degrees
    fall as rank^-0.8 over a random ranking, from s n - 100 down to a
    floor of 40; one row in 20 keeps 3 entries, the last row none, and
    row 0 the most (past the kernel's 2048 entries for one block a row
    when s n > 2148). Each row's values are 1 / its degree."""
    rows = s * n
    deg = np.clip((rows - 100) / (r.permutation(rows) + 1.0) ** 0.8, 40,
                  None).astype(int)
    deg[r.random(rows) < 0.05] = 3
    deg[-1] = 0
    deg[0] = rows - 100
    a = np.zeros((rows, rows), np.float32)
    for row, k in enumerate(deg):
        a[row, r.choice(rows, size=k, replace=False)] = 1.0 / max(k, 1)
    return a.reshape(s, n, s, n).transpose(0, 2, 1, 3)   # [i, j, v, u]


def _fused_kernels(fn):
    """Device operations named fused_gnn while ``fn`` runs, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "fused_gnn" in e.key)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(602, 16), (16, 41), (3, 16), (16, 3)])
def test_cuda_fused_gnn_power_law_hubs_match_plain(cuda, d, f):
    """reddit x0.1's layers (602 -> 16 projects first, 16 -> 41
    aggregates first) and the orders' edge (3 -> 16, 16 -> 3) on a
    6 x 6 grid of 512-row shards where nearly every row is a hub and one
    holds 2,972 entries. Each call is one launch, one fused_gnn kernel on
    the device and one count of its order; two calls give the same
    bits."""
    r = _rng(50 + d + f)
    a = _t(_power_law_blocks(r, 6, 512)).to(cuda)
    h = _t(r.standard_normal((6, 512, d), np.float32)).to(cuda)
    w = _t((r.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)).to(
        cuda)
    index = csr.linear_index(a)
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).cpu()
    assert (counts > csr.HUB_ENTRIES).float().mean() > 0.9
    assert counts.max() > 2048 and counts[-1] == 0

    def layer():
        return t_fused.fused_gnn_layer(a, h, w, activation="relu",
                                       index=index)

    t_fused.reset_routes()
    out = _counted("fused_gnn", layer)
    other = ({t_fused.PROJECT_FIRST, t_fused.AGGREGATE_FIRST}
             - {t_fused.route(d, f)}).pop()
    assert t_fused.routes() == {t_fused.route(d, f): 1, other: 0}
    torch.testing.assert_close(out, ref.fused_gnn(a, h, w, activation="relu"),
                               **TOL)
    assert torch.equal(_counted("fused_gnn", layer), out)
    assert _fused_kernels(layer) == 1


@pytest.mark.cuda
def test_cuda_gcn_forward_routes_each_layer(cuda):
    """One gcn forward at reddit's widths (602 -> 16 -> 41) on a small
    reddit-profile graph (931 nodes, nearly every row a hub): two
    fused_gnn launches, layer 0 projecting first and layer 1 aggregating
    first."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset

    ds = make_dataset("reddit", seed=0, scale=0.004)
    exe = runtime.compile(ZooSpec("gcn", 602, 16, 41, num_layers=2), ds,
                          device=cuda, backend="cuda", max_shard_n=512)
    torch.cuda.synchronize()
    _lib.reset_launches()
    t_fused.reset_routes()
    logits = exe.forward()
    torch.cuda.synchronize()
    assert logits.shape == (931, 41) and bool(torch.isfinite(logits).all())
    assert {k: v for k, v in _lib.launches().items() if v} == {"fused_gnn": 2}
    assert t_fused.routes() == {t_fused.PROJECT_FIRST: 1,
                                t_fused.AGGREGATE_FIRST: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (131, 75, 3), (131, 75, 16), (131, 75, 67), (131, 75, 500),
    (1000, 1003, 16), (1000, 500, 500), (19968, 500, 500),
    (257, 29, 33), (64, 8, 32),
])
def test_cuda_dense_engine_shapes_match_plain(cuda, m, k, n):
    """Both tile shapes (N <= 32 and above), K no multiple of 8 (nor of
    4: the 4-byte copy path), ragged M, and Pubmed's pool product."""
    r = _rng(m + k + n)
    x = _t(r.standard_normal((m, k), np.float32)).to(cuda)
    w = _t((r.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)).to(cuda)
    b = _t(r.standard_normal((n,), np.float32)).to(cuda)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(
        x, w, b, activation="relu"))
    torch.testing.assert_close(
        out, ref.dense_engine(x, w, b, activation="relu"), **TOL)


# 3xTF32 against the float64 product, relative norm at K = 1000: float32
# accumulation reads ~1e-7 there, one TF32 pass (10 mantissa bits) ~3e-4
DENSE_REL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 500])
def test_cuda_dense_engine_keeps_float32_precision(cuda, n):
    """||kernel - float64 product|| / ||float64 product|| at K = 1000 for
    both tile shapes: a single TF32 pass fails this."""
    r = _rng(32 + n)
    x = _t(r.standard_normal((2048, 1000), np.float32)).to(cuda)
    w = _t(r.standard_normal((1000, n), np.float32)).to(cuda)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(x, w))
    exact = x.double() @ w.double()
    rel = ((out.double() - exact).norm() / exact.norm()).item()
    assert rel <= DENSE_REL, f"relative norm error {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 67])
def test_cuda_dense_engine_finite_times_inf_is_signed_inf(cuda, n):
    """x · Inf gives ±Inf as in the plain product (the 3xTF32 cross terms
    must not turn it into NaN), in w and in x, for both tile shapes."""
    r = _rng(33 + n)
    x = r.standard_normal((131, 75), np.float32)
    w = r.standard_normal((75, n), np.float32)
    w[20, 5] = np.inf
    x[7, 40] = -np.inf
    x, w = _t(x).to(cuda), _t(w).to(cuda)
    out = _counted("dense_engine", lambda: t_dense.dense_engine_matmul(x, w))
    plain = ref.dense_engine(x, w)
    assert torch.isinf(plain[:, 5]).sum() >= 130
    assert torch.isinf(plain[7]).sum() >= n - 1
    torch.testing.assert_close(out, plain, equal_nan=True, **TOL)


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


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("d", [16, 45, 500, 600])
def test_cuda_seg_gather_hub_and_empty_rows_match_plain(cuda, op, d):
    """One hub destination with more than 100 in-edges (several 32-id
    batches), empty destinations, and D below one warp's 512 columns,
    ragged (45: the scalar path), at Pubmed's 500 and above 512 (two
    column blocks). With the graph's index and without, the same result."""
    r = _rng(27 + d)
    s, n, e = 3, 64, 120
    es, ed, ev = _edges(r, s, s, n, e)
    ed = np.where(ed % 5 == 0, 1, ed)     # destination 1: the hub
    ed = np.maximum(ed, 1)                # destination 0: no in-edge
    ed[:, :, :40] = 1
    ev[:, :, :40] = True
    es, ed, ev = (_t(x).to(cuda) for x in (es, ed, ev))
    h = _t(r.standard_normal((s, n, d), np.float32)).to(cuda)
    index = t_gather.gather_index(es, ed, ev, n)
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).cpu()
    assert counts.max() > 100 and (counts == 0).any()
    # the plain versions on the CPU add in slot order, as the kernel does;
    # on the card their index_add_ adds in any order
    cpu = [x.cpu() for x in (es, ed, ev, h)]
    plain = ref.seg_gather(*cpu, op=op)
    cpu_index = t_gather.GatherIndex(row_ptr=index.row_ptr.cpu(),
                                     src=index.src.cpu())
    torch.testing.assert_close(
        ref.seg_gather_indexed(cpu_index, cpu[3], op=op), plain, atol=1e-5,
        rtol=1e-5)
    for idx in (index, None):
        out = _counted("seg_gather", lambda: t_gather.seg_gather_aggregate(
            es, ed, ev, h, op=op, index=idx)).cpu()
        assert (out[:, 0] == 0).all()
        if op == "max":
            assert torch.equal(out, plain)
        else:
            torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_seg_gather_reads_nothing_outside_a_bad_index(cuda):
    """An index not made by gather_index: a source id past h and a last
    row pointer past the edge list. The kernel skips the id and stops at
    the list's end instead of reading out of range."""
    r = _rng(29)
    h = _t(r.standard_normal((2, 4, 8), np.float32)).to(cuda)
    es = torch.zeros((2, 2, 1), dtype=torch.int32, device=cuda)
    ev = torch.zeros((2, 2, 1), dtype=torch.bool, device=cuda)
    bad = t_gather.GatherIndex(
        row_ptr=torch.tensor([0, 2, 2, 2, 2, 2, 2, 2, 9], dtype=torch.int32,
                             device=cuda),
        src=torch.tensor([3, 1000], dtype=torch.int32, device=cuda))
    out = _counted("seg_gather", lambda: t_gather.seg_gather_aggregate(
        es, es, ev, h, op="sum", index=bad))
    expect = torch.zeros_like(out)
    expect[0, 0] = h.reshape(-1, 8)[3]
    torch.testing.assert_close(out, expect, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", [
    (2, 4, 2, 70, 70, 16, True, None),     # ragged, GQA, dh 16
    (1, 8, 2, 129, 200, 64, True, None),   # q suffix of kv, ragged, dh 64
    (1, 4, 1, 100, 60, 128, True, None),   # Sq > Skv: rows with no key -> 0
    (2, 4, 4, 150, 150, 128, True, 33),    # window, dh 128
    (1, 4, 2, 70, 90, 80, False, None),    # not causal, dh no power of two
    (1, 2, 2, 64, 64, 32, True, 0),        # window 0: every key masked
    (2, 8, 2, 1000, 1000, 128, True, None),  # GQA 4:1, S 1000, dh 128
    (2, 8, 2, 1000, 1000, 64, True, None),   # GQA 4:1, S 1000, dh 64
    (1, 4, 2, 70, 300, 128, False, None),  # not causal, ragged, dh 128
    (1, 2, 2, 64, 64, 64, True, 0),        # window 0, dh 64
    (1, 2, 1, 300, 2000, 128, True, 100),  # window, ragged Skv, Sq < Skv
    (2, 10, 1, 300, 300, 256, True, 128),  # MQA 10:1, dh 256, window
    (1, 4, 1, 100, 230, 256, True, None),  # dh 256, Sq < Skv, ragged
    (1, 4, 2, 70, 70, 200, False, None),   # 128 < dh < 256, not causal
    (1, 2, 2, 64, 64, 256, True, 0),       # window 0, dh 256
    (1, 4, 1, 100, 60, 256, True, None),   # Sq > Skv, dh 256
    (1, 4, 2, 70, 300, 256, False, None),  # not causal, ragged, dh 256
    (1, 4, 1, 1000, 1000, 256, True, 100),  # window 100 < S 1000, dh 256
    (2, 8, 2, 1000, 1000, 256, True, None),  # GQA 4:1, S 1000, dh 256
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, hq, hkv, sq, skv,
                                            dh, causal, window):
    r = _rng(26)
    q, k, v = (_t(a).to(cuda, dtype)
               for a in _qkv(r, b, hq, hkv, sq, skv, dh))
    # bfloat16 at dh 64, 128 and 256 runs on the tensor-core kernel
    out = _counted(t_flash._route(dtype, dh), lambda: t_flash.flash_attention(
        q, k, v, causal=causal, window=window))
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    _assert_attention_close(out, plain, dtype)
    if causal and sq > skv:
        assert (out[:, :, :sq - skv] == 0).all()
    if window == 0:
        assert (out == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_cuda_flash_attention_both_kernels_take_bf16(cuda, dh):
    """The CUDA-core kernel still takes bfloat16 at the tensor-core head
    dims (chip_smoke.py times the two side by side); both agree with the
    plain version."""
    r = _rng(28)
    q, k, v = (_t(a).to(cuda, torch.bfloat16)
               for a in _qkv(r, 2, 8, 2, 300, 300, dh))
    plain = ref.flash_attention(q, k, v)
    for kernel in ("flash_attention", "flash_attention_tc"):
        out = _counted(kernel, lambda: t_flash._launch(kernel, q, k, v))
        _assert_attention_close(out, plain, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_flash.flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 16), device=cuda)
    k = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        t_flash.flash_attention(q, k, k)
    q = torch.zeros((1, 2, 8, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        t_flash.flash_attention(q, q, q)
