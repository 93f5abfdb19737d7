"""The port's MoE, RG-LRU, SSD and windowed dh-256 attention blocks against
the reference package's, module by module.

The same numpy inputs and parameters (drawn by the reference, handed over
through ``repro_torch.models.lm.params_from_numpy``) go through ``repro``'s
``nn/moe.py``, ``nn/rglru.py``, ``nn/ssd.py`` and ``nn/attention.py`` and
the port's, at the SMOKE sizes of qwen2-moe-a2.7b, llama4-scout-17b-a16e,
recurrentgemma-2b and mamba2-1.3b. Whole-model forward, prefill and decode
of those archs are in tests/test_torch_lm.py.

Tolerances: float32 atol = rtol = 1e-4, also for the port's recurrences
against a float64 step-by-step loop. Router ties: with random float32 weights
no two router logits tie, so ``torch.topk`` and ``jax.lax.top_k`` pick the
same experts.

JAX and the reference package are imported inside fixtures only.
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import moe as t_moe
from repro_torch.nn import rglru as t_rglru
from repro_torch.nn import ssd as t_ssd

F32_TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")


@pytest.fixture(scope="module")
def jx():
    """The reference package's blocks (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke
    from repro.nn import attention, layers, moe, rglru, ssd
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke,
                                 attention=attention, layers=layers, moe=moe,
                                 rglru=rglru, ssd=ssd)


def _cfgs(jx, arch, **changes):
    return (dataclasses.replace(jx.get_smoke(arch), **changes),
            dataclasses.replace(t_configs.get_smoke(arch), **changes))


def _struct(jx, struct, cfg, seed=0):
    """A block's reference parameters as numpy, its zero biases, norm
    scales and D randomized so they count."""
    leaf = jx.layers.init_leaf(jx.jax.random.key(seed), cfg.pdtype)
    p = jx.jax.tree_util.tree_map(np.asarray, struct(leaf, "b", cfg))
    rng = np.random.default_rng(seed)

    def shake(tree):
        if isinstance(tree, dict):
            return {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                        if k in ("conv_b", "b_a", "b_i", "norm", "D")
                        else shake(v)) for k, v in tree.items()}
        return tree
    return shake(p)


def _j(jx, tree):
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)


def _t(tree):
    return t_lm.params_from_numpy(tree, "cpu")


def _close(out, exp, **tol):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else out
    np.testing.assert_allclose(out, np.asarray(exp, np.float32),
                               **(tol or F32_TOL))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Init kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_kinds_by_range_and_dtype(dtype):
    """The draws cannot equal jax.random's: held by range and dtype. The
    three SSM/LRU kinds stay float32 under a bf16 param dtype."""
    leaf = t_layers.init_leaf(torch.Generator().manual_seed(0), dtype)
    shape = (4096,)
    ones = leaf("o", shape, ("x",), init="ones")
    assert ones.dtype == dtype and (ones == 1).all()
    a_log = leaf("a", shape, ("x",), init="ssm_A")
    assert a_log.dtype == torch.float32
    assert a_log.min() >= 0 and a_log.max() <= math.log(16.0) + 1e-6
    assert a_log.max() - a_log.min() > 0.9 * math.log(16.0)
    dt_min, dt_max = 0.002, 0.05
    dt_bias = leaf("d", shape, ("x",), init="dt_bias", scale=(dt_min, dt_max))
    dt = torch.nn.functional.softplus(dt_bias)
    assert dt_bias.dtype == torch.float32
    assert dt.min() >= dt_min * (1 - 1e-4) and dt.max() <= dt_max * (1 + 1e-4)
    lam = leaf("l", shape, ("x",), init="lru_lambda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert lam.dtype == torch.float32
    assert a.min() >= 0.9 - 1e-5 and a.max() <= 0.999 + 1e-5
    assert a.max() - a.min() > 0.09
    with pytest.raises(ValueError, match="unknown init"):
        leaf("z", shape, ("x",), init="orthogonal")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _dropped(top_idx: np.ndarray, num_experts: int, cap: int) -> np.ndarray:
    """(B, S, k) bool: the (token, choice) entries the capacity drops, by
    the reference's rule: per row and expert, entries in (token, choice)
    order, all past the first ``cap``."""
    b, s, k = top_idx.shape
    drop = np.zeros((b, s * k), bool)
    for r in range(b):
        flat = top_idx[r].reshape(-1)
        for e in range(num_experts):
            drop[r, np.nonzero(flat == e)[0][cap:]] = True
    return drop.reshape(b, s, k)


@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(jx, arch, overflow, no_drop):
    """moe_apply on both MoE smoke configs, at the config's capacity
    factor (1.25: drops) and at cf = E (none). ``overflow`` steers every
    token of row 0 to expert 0 (a large router column), so that row
    overflows; the dropped entries are the reference's."""
    jcfg, tcfg = _cfgs(jx, arch)
    if no_drop:
        moe = dataclasses.replace(jcfg.moe,
                                  capacity_factor=float(jcfg.moe.num_experts))
        jcfg, tcfg = (dataclasses.replace(c, moe=moe) for c in (jcfg, tcfg))
    p = _struct(jx, jx.moe.moe_struct, jcfg)
    b, s = 2, 24
    x = _x((b, s, jcfg.d_model), 7)
    if overflow:   # expert 0's logit ~5 in row 0, others ~0.2
        u = _x((jcfg.d_model,), 11)
        u /= np.linalg.norm(u)
        p["router"] = p["router"].copy()
        p["router"][:, 0] = 0.5 * u
        x[0] += 10.0 * u
    exp = jx.moe.moe_apply(_j(jx, p), jx.jnp.asarray(x), jcfg)
    tp = _t(p)
    out = t_moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(out, exp)

    top_idx, _ = t_moe.route(tp, torch.from_numpy(x), tcfg)
    logits = np.asarray(x @ p["router"], np.float32)
    _, j_idx = jx.jax.lax.top_k(jx.jnp.asarray(logits), jcfg.moe.top_k)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(j_idx))
    _, _, _, keep_tok, cap = t_moe.dispatch(top_idx, tcfg, s)
    assert cap == t_moe._capacity(s, tcfg.moe) == jx.moe._capacity(
        s, jcfg.moe)
    want = _dropped(np.asarray(j_idx), jcfg.moe.num_experts, cap)
    np.testing.assert_array_equal(~keep_tok.numpy().reshape(want.shape),
                                  want)
    assert want.any() == (overflow and not no_drop)


def test_moe_capacity_at_decode_is_top_k():
    """One token a row (decode): capacity T·k, no floor of 8."""
    m = t_configs.get_config("qwen2-moe-a2.7b").moe
    assert t_moe._capacity(1, m) == 4
    assert t_moe._capacity(1024, m) == 88
    assert t_moe._capacity(1024, t_configs.get_config(
        "llama4-scout-17b-a16e").moe) == 88


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_apply_and_decode_match_reference(jx):
    """rglru_apply with return_state over a prompt, then rglru_decode for
    a few tokens from that state."""
    jcfg, tcfg = _cfgs(jx, "recurrentgemma-2b")
    p = _struct(jx, jx.rglru.rglru_struct, jcfg)
    tp = _t(p)
    b, s = 2, 21
    x = _x((b, s + 3, jcfg.d_model), 8)
    exp, jcache = jx.rglru.rglru_apply(_j(jx, p), jx.jnp.asarray(x[:, :s]),
                                       jcfg, return_state=True)
    out, cache = t_rglru.rglru_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                     return_state=True)
    _close(out, exp)
    _close(cache["h"], jcache["h"])
    _close(cache["conv"], jcache["conv"])
    for t in range(s, s + 3):
        exp, jcache = jx.rglru.rglru_decode(
            _j(jx, p), jx.jnp.asarray(x[:, t:t + 1]), jcfg, jcache)
        out, cache = t_rglru.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                          tcfg, cache)
        _close(out, exp)
        _close(cache["h"], jcache["h"])


@pytest.mark.parametrize("s", [1, 7, 64, 1000])
def test_linear_scan_matches_a_sequential_recurrence(s):
    """The doubling scan against h_t = a_t h_{t-1} + u_t in float64, with
    a in the RG-LRU's range (0.9^8 .. 1): no underflow over 1000 steps."""
    r = np.random.default_rng(s)
    a = r.uniform(0.9 ** 8, 1.0, (2, s, 5))
    u = r.standard_normal((2, s, 5))
    h, want = np.zeros((2, 5)), np.empty((2, s, 5))
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        want[:, t] = h
    got = t_rglru.linear_scan(torch.from_numpy(a).float(),
                              torch.from_numpy(u).float())
    np.testing.assert_allclose(got.double().numpy(), want, atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l", [16, 21])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_matches_reference(jx, l, init):
    """_ssd_scan with and without an initial state; l = 21 is no multiple
    of the smoke chunk size (8), n_groups 2 maps heads to groups."""
    jcfg, tcfg = _cfgs(jx, "mamba2-1.3b")
    ssm = dataclasses.replace(jcfg.ssm, n_groups=2)
    jcfg, tcfg = (dataclasses.replace(c, ssm=ssm) for c in (jcfg, tcfg))
    _, _, h, _ = jx.ssd._dims(jcfg)
    r = np.random.default_rng(l)
    b, p, g, n = 2, ssm.head_dim, ssm.n_groups, ssm.d_state
    x = r.standard_normal((b, l, h, p)).astype(np.float32)
    dt = r.uniform(0.01, 0.3, (b, l, h)).astype(np.float32)
    a_log = np.log(r.uniform(1, 16, h)).astype(np.float32)
    bb = r.standard_normal((b, l, g, n)).astype(np.float32)
    cc = r.standard_normal((b, l, g, n)).astype(np.float32)
    st = r.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    args = (x, dt, a_log, bb, cc)
    ey, es = jx.ssd._ssd_scan(*(jx.jnp.asarray(a) for a in args), jcfg,
                              init_state=None if st is None
                              else jx.jnp.asarray(st))
    ty, ts = t_ssd._ssd_scan(*(torch.from_numpy(a) for a in args), tcfg,
                             init_state=None if st is None
                             else torch.from_numpy(st))
    _close(ty, ey)
    _close(ts, es)
    if not init:   # the chunked form is the step-by-step state recurrence
        state = np.zeros((b, h, p, n))
        want = np.empty((b, l, h, p))
        hpg = h // g
        for t in range(l):
            da = np.exp(dt[:, t] * -np.exp(a_log.astype(np.float64)))
            bh = np.repeat(bb[:, t], hpg, axis=1)
            ch = np.repeat(cc[:, t], hpg, axis=1)
            state = state * da[..., None, None] + np.einsum(
                "bh,bhp,bhk->bhpk", dt[:, t], x[:, t], bh)
            want[:, t] = np.einsum("bhpk,bhk->bhp", state, ch)
        np.testing.assert_allclose(ty.double().numpy(), want, atol=1e-4,
                                   rtol=1e-4)


def test_ssd_prefill_cache_and_decode_match_reference(jx):
    jcfg, tcfg = _cfgs(jx, "mamba2-1.3b")
    p = _struct(jx, jx.ssd.ssd_struct, jcfg)
    tp = _t(p)
    b, s = 2, 19
    x = _x((b, s + 3, jcfg.d_model), 9)
    exp, jcache = jx.ssd.ssd_prefill_cache(_j(jx, p),
                                           jx.jnp.asarray(x[:, :s]), jcfg)
    out, cache = t_ssd.ssd_prefill_cache(tp, torch.from_numpy(x[:, :s]),
                                         tcfg)
    _close(out, exp)
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])
    _close(t_ssd.ssd_apply(tp, torch.from_numpy(x[:, :s]), tcfg), exp)
    for t in range(s, s + 3):
        exp, jcache = jx.ssd.ssd_decode(_j(jx, p), jx.jnp.asarray(
            x[:, t:t + 1]), jcfg, jcache)
        out, cache = t_ssd.ssd_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcfg, cache)
        _close(out, exp)
        _close(cache["state"], jcache["state"])


# ---------------------------------------------------------------------------
# Local attention at recurrentgemma's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [24, 40])
def test_windowed_attention_at_head_dim_256_matches_reference(jx, s):
    """attn_apply with window 16 at dh 256, MQA (recurrentgemma's local
    attention, smoke width): s = 40 > 2 * 16 takes the reference's banded
    path, s = 24 its chunked one; the port runs its kernel's plain
    version."""
    jcfg, tcfg = _cfgs(jx, "recurrentgemma-2b", head_dim=256)
    leaf = jx.layers.init_leaf(jx.jax.random.key(4), jcfg.pdtype)
    p = jx.jax.tree_util.tree_map(np.asarray,
                                  jx.attention.attn_struct(leaf, "a", jcfg))
    x = _x((2, s, jcfg.d_model), 10)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    exp = jx.attention.attn_apply(_j(jx, p), jx.jnp.asarray(x), jcfg,
                                  jx.jnp.asarray(pos), window=16)
    out = t_attn.attn_apply(_t(p), torch.from_numpy(x), tcfg,
                            torch.from_numpy(pos.copy()), window=16,
                            backend="cuda")
    _close(out, exp)


# ---------------------------------------------------------------------------
# The recurrent archs' serving handoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
@pytest.mark.parametrize("s", [10, 16])
def test_short_prompt_prefill_decode_match_own_forward(arch, s):
    """Prompts shorter than (10) and equal to (16) recurrentgemma's window
    of 16, decoding past it so the ring buffer wraps: the reference cannot
    build a window cache from a prompt shorter than its window (ROADMAP.md
    Queue 3), so the port is held to its own forward."""
    cfg = t_configs.get_smoke(arch)
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + 12)).astype(np.int32))
    full = t_lm.forward(params, cfg, {"tokens": toks})
    logits, caches = t_lm.prefill(params, cfg, {"tokens": toks[:, :s]},
                                  s + 13)
    _close(logits[:, 0], full[:, s - 1], atol=2e-4, rtol=2e-4)
    for t in range(s, s + 12):
        logits, caches = t_lm.decode_step(
            params, cfg, {"tokens": toks[:, t:t + 1], "pos": t}, caches)
        _close(logits[:, 0], full[:, t], atol=5e-4, rtol=5e-4)
