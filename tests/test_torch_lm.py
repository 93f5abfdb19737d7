"""The port's dense LM stack against the reference package's.

The same numpy inputs and parameters (drawn by the reference, handed over
through ``repro_torch.models.lm.params_from_numpy``) go through
``repro``'s layers, forward, prefill/decode and ServeEngine and through
the port's, at the SMOKE sizes of qwen3-8b (qk-norm, untied head),
qwen2.5-3b (QKV bias, tied embeddings), minicpm-2b (tied embeddings, MHA,
the μP embedding, residual and logit scales), command-r-plus-104b
(GQA 4:1, untied head), qwen2-moe-a2.7b (MoE, softmax router, shared
experts), llama4-scout-17b-a16e (MoE, sigmoid router), recurrentgemma-2b
(RG-LRU and local attention, window 16), mamba2-1.3b (SSD, no MLP),
qwen2-vl-2b (embedding inputs, M-RoPE) and musicgen-large (four
codebooks). The last two are held in more depth in
tests/test_torch_lm_inputs.py.
On the CPU the port's attention runs the plain version of its
flash-attention kernel. The modules of the last four are held alone in
tests/test_torch_lm_blocks.py.

Tolerances: float32 1e-4 (2e-4 / 5e-4 for prefill / decode against the
full forward, as tests/test_lm_consistency.py). bfloat16 is compared in
float32 after the fact; the two frameworks round at other places inside
the matmuls, so a layer's outputs may differ by a couple of bf16 ulps
(2^-8 relative each) and the 2-layer forward's logits by a few hundredths
(0.055 at most for qwen3-8b-smoke, logits up to 4.6 in magnitude;
``BF16_TOL`` allows 0.1 + 5%).

JAX and the reference package are imported inside fixtures only.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import rope as t_rope
from repro_torch.serving import (Completed, Rejected, Request,
                                 SchedulerConfig, ServeEngine, Server)

DENSE_ARCHS = ("qwen3-8b", "qwen2.5-3b", "minicpm-2b", "command-r-plus-104b")
ARCHS = DENSE_ARCHS + ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                       "recurrentgemma-2b", "mamba2-1.3b", "qwen2-vl-2b",
                       "musicgen-large")
# the archs the ServeEngine takes (token inputs), as in the reference
TOKEN_ARCHS = tuple(a for a in ARCHS if a != "qwen2-vl-2b")
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-1, rtol=5e-2)


@pytest.fixture(scope="module")
def jx():
    """The reference package's LM stack (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke
    from repro.models import lm
    from repro.nn import attention, layers, rope
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServeEngine as JaxEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, lm=lm,
                                 attention=attention, layers=layers, rope=rope,
                                 Request=JaxRequest, ServeEngine=JaxEngine)


def _cfgs(jx, arch, dtype="float32"):
    """(reference cfg, port cfg) for ``arch``'s SMOKE config in ``dtype``."""
    jcfg = dataclasses.replace(jx.get_smoke(arch), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(t_configs.get_smoke(arch), param_dtype=dtype,
                               compute_dtype=dtype)
    return jcfg, tcfg


def _numpy_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _no_drop(cfg):
    """``cfg`` with a MoE capacity that drops no token (capacity factor =
    number of experts), as tests/test_lm_consistency.py does: only then
    does prefill + decode reproduce the full forward."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _randomize_small_leaves(tree, rng):
    """Biases and norm scales start at 0 (the SSD's D at 1); make them
    count."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                    if k in ("bq", "bk", "bv", "q_norm", "k_norm", "ln1",
                             "ln2", "final_norm", "b_a", "b_i", "conv_b",
                             "norm", "D")
                    else _randomize_small_leaves(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_small_leaves(v, rng) for v in tree]
    return tree


def _params(jx, jcfg, seed=0):
    """The reference's parameters as numpy (bf16 leaves as ml_dtypes)."""
    p = _numpy_tree(jx, jx.lm.init_params(jcfg, jx.jax.random.key(seed)))
    return _randomize_small_leaves(p, np.random.default_rng(seed))


def _j(jx, tree):
    """A numpy tree as JAX arrays (numpy bfloat16 leaves would promote
    under numpy's own arithmetic inside the reference)."""
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)


def _inputs(cfg, rng, b: int, s: int) -> dict:
    """A numpy model input of ``cfg``'s kind: tokens (b, s), or (b, s, C)
    for C codebooks, or float32 embeddings (b, s, d)."""
    if cfg.input_mode == "embeddings":
        return {"embeddings":
                rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}


def _sliced(batch: dict, sl) -> dict:
    """Every input of ``batch`` over the positions ``sl``."""
    return {k: v[:, sl] for k, v in batch.items()}


def _jb(jx, batch: dict) -> dict:
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(out, exp, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(out), _f32(exp), **tol)


def _to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(jx, dtype):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = r.standard_normal(64).astype(np.float32)
    jd = getattr(jx.jnp, dtype)
    exp = jx.layers.rms_norm(jx.jnp.asarray(x, jd), jx.jnp.asarray(s), 1e-6)
    out = t_layers.rms_norm(_to(x, dtype), torch.from_numpy(s), 1e-6)
    assert out.dtype == getattr(torch, dtype)
    _close(out, exp, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(jx, dtype):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 4, 40, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(40) + 1000]).astype(np.int32)
    jd = getattr(jx.jnp, dtype)
    exp = jx.rope.apply_rope(jx.jnp.asarray(x, jd), jx.jnp.asarray(pos),
                             1_000_000.0)
    out = t_rope.apply_rope(_to(x, dtype), torch.from_numpy(pos), 1_000_000.0)
    _close(out, exp, dtype)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(jx, kind, dtype):
    r = np.random.default_rng(2)
    leaf = jx.layers.init_leaf(jx.jax.random.key(2), getattr(jx.jnp, dtype))
    p = _numpy_tree(jx, jx.layers.mlp_struct(leaf, "m", 64, 128, kind))
    x = r.standard_normal((2, 6, 64)).astype(np.float32)
    exp = jx.layers.mlp_apply(_j(jx, p),
                              jx.jnp.asarray(x, getattr(jx.jnp, dtype)), kind)
    out = t_layers.mlp_apply(t_lm.params_from_numpy(p, "cpu"),
                             _to(x, dtype), kind)
    _close(out, exp, dtype)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("s,window", [(24, None), (40, None), (24, 16),
                                      (40, 16)])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_attn_apply_matches_reference(jx, arch, s, window, backend):
    """qwen3 covers qk-norm, qwen2.5 QKV bias; s = 40 > 2 * 16 takes the
    reference's banded local path, s = 24 its chunked one."""
    jcfg, tcfg = _cfgs(jx, arch)
    p = _params(jx, jcfg)["layers"][0]["attn"]
    x = np.random.default_rng(3).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    exp, (ek, ev) = jx.attention.attn_apply(
        _j(jx, p), jx.jnp.asarray(x), jcfg, jx.jnp.asarray(pos), window=window,
        return_kv=True)
    out, (k, v) = t_attn.attn_apply(
        t_lm.params_from_numpy(p, "cpu"), torch.from_numpy(x), tcfg,
        torch.from_numpy(pos.copy()), window=window, return_kv=True,
        backend=backend)
    _close(out, exp, "float32")
    _close(k, ek, "float32")
    _close(v, ev, "float32")


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_cache_and_decode_match_reference(jx, window):
    """attn_prefill_cache + attn_decode, global and ring-buffer (window 8
    < max_len 32), a few steps past the prompt."""
    jcfg, tcfg = _cfgs(jx, "qwen3-8b")
    p = _params(jx, jcfg)["layers"][0]["attn"]
    tp = t_lm.params_from_numpy(p, "cpu")
    r = np.random.default_rng(4)
    b, s, max_len = 2, 12, 32
    x = r.standard_normal((b, s + 3, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jp = _j(jx, p)
    _, (jk, jv) = jx.attention.attn_apply(
        jp, jx.jnp.asarray(x[:, :s]), jcfg, jx.jnp.asarray(pos), window=window,
        return_kv=True)
    jcache = jx.attention.attn_prefill_cache(jk, jv, max_len, window)
    _, (k, v) = t_attn.attn_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                  torch.from_numpy(pos.copy()), window=window,
                                  return_kv=True)
    cache = t_attn.attn_prefill_cache(k, v, max_len, window)
    _close(cache["k"], jcache["k"], "float32")
    for t in range(s, s + 3):
        exp, jcache = jx.attention.attn_decode(
            jp, jx.jnp.asarray(x[:, t:t + 1]), jcfg, jcache, jx.jnp.int32(t),
            window=window)
        out, cache = t_attn.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                        tcfg, cache, t, window=window)
        _close(out, exp, "float32")
        _close(cache["v"], jcache["v"], "float32")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_struct(jx, arch):
    """Same keys, shapes and dtypes as the reference's init (bfloat16, but
    float32 for the SSD's A_log and dt_bias and the RG-LRU's Λ), drawn on
    the generator's device; ``num_params`` counts them, but for the conv
    biases it leaves out (``uncounted_params``)."""
    jcfg, tcfg = _cfgs(jx, arch, "bfloat16")
    exp = _numpy_tree(jx, jx.lm.init_params(jcfg, jx.jax.random.key(0)))
    got = t_lm.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_e = jx.jax.tree_util.tree_flatten_with_path(exp)[0]
    flat_g = jx.jax.tree_util.tree_flatten_with_path(
        jx.jax.tree_util.tree_map(lambda t: t, got))[0]
    assert [str(k) for k, _ in flat_e] == [str(k) for k, _ in flat_g]
    for (path, e), (_, g) in zip(flat_e, flat_g):
        assert tuple(e.shape) == tuple(g.shape)
        f32 = str(path[-1]) in ("['A_log']", "['dt_bias']", "['lam']")
        want = "float32" if f32 else "bfloat16"
        assert str(g.dtype) == f"torch.{want}" and str(e.dtype) == want
    assert sum(g.numel() for _, g in flat_g) \
        == tcfg.num_params() + t_lm.uncounted_params(tcfg) \
        == sum(e.size for _, e in flat_e)
    assert tcfg.num_params() == jcfg.num_params()


def _record_router_logits(jx, monkeypatch):
    """Record each MoE layer's float32 router logits (B, S, E) on both
    sides, in layer order: ([reference's], [port's])."""
    jrec, trec = [], []
    j_moe, t_moe = jx.lm.moe_apply, t_lm.moe_apply

    def j_rec(p, x, cfg, constrain=None):
        jrec.append(np.asarray(x.astype(jx.jnp.float32)
                               @ p["router"].astype(jx.jnp.float32)))
        return j_moe(p, x, cfg, constrain)

    def t_rec(p, x, cfg, constrain=None):
        trec.append((x.float() @ p["router"].float()).numpy())
        return t_moe(p, x, cfg, constrain)

    monkeypatch.setattr(jx.lm, "moe_apply", j_rec)
    monkeypatch.setattr(t_lm, "moe_apply", t_rec)
    return jrec, trec


def _rows_unflipped(jrec, trec, k: int) -> np.ndarray:
    """(B, S) mask of the positions no routing flip reaches. A flip (the
    two sides' top-k sets differ) must be explained by the logits: the
    reference's gap between its k-th and (k+1)-th logit there is below
    twice the largest difference between the two sides' logits in that
    layer. At no-drop capacity a flip changes its own token only, and
    through causal attention the later positions of its row in later
    layers."""
    last = len(jrec) - 1
    clean = np.ones(jrec[0].shape[:2], bool)
    for layer, (je, te) in enumerate(zip(jrec, trec)):
        delta = np.abs(je - te).max()
        top = np.sort(je, axis=-1)[..., ::-1]
        gap = top[..., k - 1] - top[..., k]
        jset = np.sort(np.argsort(-je, axis=-1, kind="stable")[..., :k], -1)
        tset = np.sort(np.argsort(-te, axis=-1, kind="stable")[..., :k], -1)
        flips = (jset != tset).any(-1)
        assert (gap[flips] < 2 * delta).all(), (layer, gap[flips], delta)
        for b, t in zip(*np.nonzero(flips)):
            if layer == last:
                clean[b, t] = False
            else:
                clean[b, t:] = False
    return clean


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(jx, arch, dtype, monkeypatch):
    """In bfloat16 the two frameworks round at other places, so a MoE
    router may pick another expert where two logits nearly tie: the MoE
    archs run bf16 at no-drop capacity, every flip must be such a near
    tie, and the positions no flip reaches are compared."""
    jcfg, tcfg = _cfgs(jx, arch, dtype)
    routed = jcfg.moe is not None and dtype == "bfloat16"
    if routed:
        jcfg, tcfg = _no_drop(jcfg), _no_drop(tcfg)
    p = _params(jx, jcfg)
    batch = _inputs(jcfg, np.random.default_rng(5), 2, 24)
    jrec, trec = _record_router_logits(jx, monkeypatch)
    exp = jx.lm.forward(_j(jx, p), jcfg, _jb(jx, batch))
    out = t_lm.forward(t_lm.params_from_numpy(p, "cpu"), tcfg, _tb(batch))
    assert out.shape == (2, 24) + ((jcfg.n_codebooks,)
                                   if jcfg.n_codebooks > 1 else ()) \
        + (jcfg.vocab_size,)
    assert out.dtype == getattr(torch, dtype)
    assert len(jrec) == len(trec) == sum(
        tcfg.is_moe_layer(i) for i in range(tcfg.n_layers))
    if routed:
        clean = _rows_unflipped(jrec, trec, jcfg.moe.top_k)
        assert clean.mean() >= 0.5, clean
        _close(_f32(out)[clean], _f32(exp)[clean], dtype)
    else:
        _close(out, exp, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference_and_own_forward(jx, arch):
    """Mirrors tests/test_lm_consistency.py: prefill + decode reproduce
    the full forward position for position (MoE at no-drop capacity),
    and equal the reference's. s = 24 exceeds recurrentgemma's window of
    16: the reference cannot build a window cache from a shorter prompt
    (ROADMAP.md Queue 3); the port's short-prompt branch is held to its
    own forward in tests/test_torch_lm_blocks.py."""
    jcfg, tcfg = (_no_drop(c) for c in _cfgs(jx, arch))
    p = _params(jx, jcfg)
    tp = t_lm.params_from_numpy(p, "cpu")
    b, s, max_len = 2, 24, 32
    batch = _inputs(jcfg, np.random.default_rng(6), b, s + 3)
    full = t_lm.forward(tp, tcfg, _tb(batch))
    logits, caches = t_lm.prefill(tp, tcfg, _tb(_sliced(batch, slice(0, s))),
                                  max_len)
    jp = _j(jx, p)
    jlogits, jcaches = jx.lm.prefill(
        jp, jcfg, _jb(jx, _sliced(batch, slice(0, s))), max_len)
    np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, s - 1]),
                               atol=2e-4, rtol=2e-4)
    _close(logits, jlogits, "float32")
    for t in range(s, s + 3):
        step = _sliced(batch, slice(t, t + 1))
        logits, caches = t_lm.decode_step(tp, tcfg, {**_tb(step), "pos": t},
                                          caches)
        jlogits, jcaches = jx.lm.decode_step(
            jp, jcfg, {**_jb(jx, step), "pos": jx.jnp.int32(t)}, jcaches)
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, t]),
                                   atol=5e-4, rtol=5e-4)
        _close(logits, jlogits, "float32")
        assert len(caches) == tcfg.n_layers


def test_decode_from_empty_cache_struct_matches_forward():
    """Decoding token by token from ``cache_struct``'s zero caches
    reproduces the full forward (no prefill at all)."""
    cfg = t_configs.get_smoke("qwen2.5-3b")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    full = t_lm.forward(params, cfg, {"tokens": toks})
    caches = t_lm.cache_struct(cfg, 2, 8)
    assert caches[0]["k"].shape == (2, cfg.n_kv_heads, 8, cfg.head_dim)
    for t in range(5):
        logits, caches = t_lm.decode_step(
            params, cfg, {"tokens": toks[:, t:t + 1], "pos": t}, caches)
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, t]),
                                   atol=5e-4, rtol=5e-4)


def test_params_from_numpy_keeps_dtypes_bit_exact(jx):
    jcfg, _ = _cfgs(jx, "qwen2.5-3b", "bfloat16")
    p = _numpy_tree(jx, jx.lm.init_params(jcfg, jx.jax.random.key(7)))
    t = t_lm.params_from_numpy(p, "cpu")
    e, g = p["embed"], t["embed"]
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                  e.view(np.int16))
    f = np.random.default_rng(7).standard_normal((3, 5)).astype(np.float32)
    g = t_lm.params_from_numpy({"w": [f]}, "cpu")["w"][0]
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy().view(np.int32), f.view(np.int32))


def test_unported_archs_and_blocks_raise():
    """The archs that waited for items 7.5 and 7.6 (qwen2-vl-2b,
    musicgen-large) and the three fields they need (``rope_kind="mrope"``,
    ``input_mode="embeddings"``, ``n_codebooks`` 4) now build, as a
    local_attn pattern does; only an unknown block kind still raises
    (``ValueError``, where the layer is built). ``ARCHS`` holds the
    reference's ten, in its order."""
    cfg = dataclasses.replace(t_configs.get_smoke("qwen3-8b"),
                              block_pattern=("attn", "local_attn"),
                              local_window=8)
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert "attn" in params["layers"][1]
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        assert t_configs.get_config(arch).name == arch
        t_lm.init_params(t_configs.get_smoke(arch),
                         torch.Generator().manual_seed(0))
    for field, value, leaf, shape in (
            ("rope_kind", "mrope", "embed", (256, 64)),
            ("input_mode", "embeddings", "embed_proj", (64, 64)),
            ("n_codebooks", 4, "lm_head", (4, 64, 256))):
        bad = dataclasses.replace(cfg, **{field: value},
                                  mrope_sections=(2, 3, 3))
        built = t_lm.init_params(bad, torch.Generator().manual_seed(0))
        assert tuple(built[leaf].shape) == shape
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        t_lm.init_params(dataclasses.replace(cfg,
                                             block_pattern=("attn", "conv")),
                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown arch"):
        t_configs.get_config("qwen2-vl-7b")
    assert t_configs.ARCHS == (
        "llama4-scout-17b-a16e", "qwen2-moe-a2.7b", "qwen2.5-3b", "qwen3-8b",
        "minicpm-2b", "command-r-plus-104b", "qwen2-vl-2b", "musicgen-large",
        "recurrentgemma-2b", "mamba2-1.3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_for_field(jx, arch):
    from repro.configs.registry import get_config as jax_get_config

    for ours, theirs in ((t_configs.get_config(arch), jax_get_config(arch)),
                         (t_configs.get_smoke(arch), jx.get_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.num_params() == theirs.num_params()


def test_full_configs_match_assignment_and_param_counts():
    """tests/test_archs.py's hyper-parameters and nameplate bounds."""
    spec = {"minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
            "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000)}
    for arch, want in spec.items():
        cfg = t_configs.get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab_size) == want
    for arch, (want, tol) in {"command-r-plus-104b": (104e9, 0.15),
                              "minicpm-2b": (2.7e9, 0.15),
                              "qwen3-8b": (8.2e9, 0.15),
                              "qwen2-moe-a2.7b": (14.3e9, 0.15),
                              "llama4-scout-17b-a16e": (109e9, 0.15),
                              "recurrentgemma-2b": (2.7e9, 0.15),
                              "mamba2-1.3b": (1.3e9, 0.15)}.items():
        got = t_configs.get_config(arch).num_params()
        assert abs(got - want) / want < tol, (arch, got, want)
    mini = t_configs.get_config("minicpm-2b")
    assert mini.tie_embeddings and mini.head_dim == 64
    assert (mini.emb_scale, mini.logit_scale) == (12.0, 1.0 / 9.0)
    assert not t_configs.get_config("command-r-plus-104b").tie_embeddings


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_generate_greedy_matches_reference_engine(jx, arch):
    """Mirrors tests/test_serving.py::test_greedy_matches_forward_argmax:
    the same batch through both engines gives the same tokens (MoE at
    no-drop capacity, so that the full forward agrees too; prompts longer
    than a local window, as the reference needs)."""
    jcfg, tcfg = (_no_drop(c) for c in _cfgs(jx, arch))
    p = _params(jx, jcfg)
    rng = np.random.default_rng(0)
    plen = 12 if jcfg.local_window is None else jcfg.local_window + 4
    prompts = [_inputs(jcfg, rng, 1, plen)["tokens"][0] for _ in range(2)]
    exp = jx.ServeEngine(jcfg, _j(jx, p), max_len=48).generate(
        [jx.Request(q, max_new_tokens=6) for q in prompts])
    eng = ServeEngine(tcfg, p, max_len=48, device="cpu")
    out = eng.generate([Request(q, max_new_tokens=6) for q in prompts])
    for o, e in zip(out, exp):
        np.testing.assert_array_equal(o, e)
    # ... and equal the argmax of the port's own full forward, step by step
    for i, q in enumerate(prompts):
        seq = torch.from_numpy(q)[None]
        for _ in range(6):
            logits = t_lm.forward(eng.params, tcfg, {"tokens": seq})
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            seq = torch.cat([seq, nxt], dim=1)
        np.testing.assert_array_equal(out[i], seq[0, len(q):].numpy())
    assert eng.stats["prefill_batches"] == 1
    assert eng.stats["decode_steps"] == 5


def _smoke_engine(arch="qwen3-8b", seed=0, **kw):
    cfg = t_configs.get_smoke(arch)
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(seed))
    return ServeEngine(cfg, params, device="cpu", **kw)


def test_server_buckets_by_prompt_length_and_matches_direct_generate():
    """Mirrors tests/test_serving.py::
    test_server_buckets_by_prompt_length_and_matches_direct_generate."""
    eng = _smoke_engine(max_len=48)
    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(4)
    short = [Request(rng.integers(0, vocab, 8).astype(np.int32),
                     max_new_tokens=4) for _ in range(3)]
    long = [Request(rng.integers(0, vocab, 12).astype(np.int32),
                    max_new_tokens=4) for _ in range(2)]
    srv = Server(eng, SchedulerConfig(max_batch_size=2))
    tickets = [srv.submit(r) for r in short + long]
    assert srv.drain() == 5
    # prompt-length buckets: 8-token prompts form batches [2,1], 12-token [2]
    m = srv.metrics()
    assert m["batches"] == 3 and m["completed"] == 5
    for r, t in zip(short + long, tickets):
        out = t.result()
        assert isinstance(out, Completed)
        np.testing.assert_array_equal(out.value, eng.generate([r], seed=0)[0])
    too_long = srv.submit(Request(np.zeros(60, np.int32), max_new_tokens=4))
    out = too_long.poll()
    assert isinstance(out, Rejected) and "max_len" in out.reason


def test_temperature_sampling_is_reproducible_from_its_seed():
    eng = _smoke_engine("qwen2.5-3b", max_len=48)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, eng.cfg.vocab_size, 10).astype(np.int32)
               for _ in range(3)]
    reqs = [Request(prompts[0], 8, temperature=0.0),
            Request(prompts[1], 8, temperature=1.5),
            Request(prompts[2], 8, temperature=1.5)]
    a = eng.generate(reqs, seed=3)
    b = eng.generate(reqs, seed=3)
    c = eng.generate(reqs, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any((x != y).any() for x, y in zip(a[1:], c[1:]))
    for x in a:
        assert x.shape == (8,) and x.dtype == np.int32
        assert ((x >= 0) & (x < eng.cfg.vocab_size)).all()
    # the temperature-0 row is greedy whatever the seed
    np.testing.assert_array_equal(a[0], c[0])
    np.testing.assert_array_equal(a[0],
                                  eng.generate([reqs[0]], seed=9)[0])


def test_launcher_lm_mode_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main, parser

    main(["--device", "cpu", "--arch", "qwen2.5-3b", "--num-requests", "3",
          "--prompt-len", "8", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 3/3 requests, 9 tokens" in out
    assert "qwen2.5-3b-smoke" in out
    args = parser().parse_args([])
    assert (args.mode, args.arch, args.smoke) == ("lm", "qwen3-8b", True)
    assert parser().parse_args(["--no-smoke"]).smoke is False
