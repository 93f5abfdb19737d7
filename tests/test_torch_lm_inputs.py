"""The port's LM inputs and outputs against the reference package's:
M-RoPE with embedding inputs (qwen2-vl-2b), codebooks (musicgen-large),
the loss, the scanned forward, the attention op's backward on the
``cuda`` backend, and the registry's shapes.

The same numpy inputs and parameters (drawn by the reference, handed over
through ``repro_torch.models.lm.params_from_numpy``) go through both
packages at the SMOKE sizes, in float32. Tolerances: 1e-6 for a rotation,
1e-5 for a gradient, 1e-4 for logits and losses (2e-4 / 5e-4 for prefill /
decode against the full forward, as tests/test_lm_consistency.py; 2e-4
for the scanned forward, as tests/test_archs.py).

JAX and the reference package are imported inside fixtures only.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import registry as t_registry
from repro_torch.models import lm as t_lm
from repro_torch.nn import rope as t_rope
from repro_torch.serving import (Completed, Request, SchedulerConfig,
                                 ServeEngine, Server)

SCAN_ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "mamba2-1.3b",
              "musicgen-large")


@pytest.fixture(scope="module")
def jx():
    """The reference package's LM stack (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.kernels import ops
    from repro.models import lm
    from repro.nn import rope
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry, ops=ops,
                                 lm=lm, rope=rope)


def _params(jx, cfg, seed=0):
    """The reference's parameters as numpy, its norms and biases made to
    count (they start at 0)."""
    p = jx.jax.tree_util.tree_map(
        np.asarray, jx.lm.init_params(cfg, jx.jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                        if k in ("bq", "bk", "bv", "ln1", "ln2",
                                 "final_norm", "b_a", "b_i", "conv_b",
                                 "norm", "D") else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(p)


def _j(jx, tree):
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)


def _inputs(cfg, rng, b: int, s: int, labels: bool = False) -> dict:
    """Numpy model inputs of ``cfg``'s kind (tokens (b, s) or (b, s, C),
    or embeddings (b, s, d)), with ``labels`` shaped like the tokens and
    a few of them -100."""
    tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    if cfg.input_mode == "embeddings":
        batch = {"embeddings":
                 rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens":
                 rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)
        lab[rng.random(tshape) < 0.2] = -100
        batch["labels"] = lab
    return batch


def _jb(jx, batch: dict) -> dict:
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def image_grid_ids(b: int, n_text: int, gh: int, gw: int,
                   n_after: int) -> np.ndarray:
    """(3, b, S) M-RoPE ids as Qwen2-VL lays them out: ``n_text`` text
    tokens with equal (t, h, w) ids, a gh x gw image grid at one temporal
    id with h and w running over the grid, then ``n_after`` text tokens
    from max id + 1."""
    ids = [np.repeat(np.arange(n_text), 3).reshape(n_text, 3)]
    r, c = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    t0 = n_text
    ids.append(np.stack([np.full(gh * gw, t0), t0 + r.ravel(),
                         t0 + c.ravel()], 1))
    start = t0 + max(gh, gw)
    ids.append(np.repeat(np.arange(start, start + n_after), 3)
               .reshape(n_after, 3))
    one = np.concatenate(ids).T.astype(np.int32)          # (3, S)
    return np.ascontiguousarray(np.broadcast_to(one[:, None],
                                                (3, b, one.shape[1])))


# ---------------------------------------------------------------------------
# The attention op's backward on the cuda backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,hkv,window", [
    (32, 32, 2, None),    # tests/test_kernels_grad.py's shape
    (16, 32, 2, None),    # causal with Sq < Skv (query offset)
    (32, 32, 2, 8),       # a window
    (32, 32, 1, None),    # GQA 2:1
])
def test_cuda_attention_backward_is_the_plain_vjp(jx, monkeypatch, sq, skv,
                                                  hkv, window):
    """``CudaBackend.attention`` on a kernel stand-in that, like the
    ctypes launch, returns a tensor with no ``grad_fn``: the q, k and v
    gradients must still be autograd of the plain version, and equal
    ``jax.grad`` of the reference's ``ops.attention`` (its Pallas kernel
    in interpret mode with the oracle's backward)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, sq, 16)).astype(np.float32)
    k = rng.standard_normal((1, hkv, skv, 16)).astype(np.float32)
    v = rng.standard_normal((1, hkv, skv, 16)).astype(np.float32)
    launched = []

    def stand_in(q, k, v, *, causal=True, window=None, scale=None):
        launched.append(q.shape)
        return t_ref.flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale).detach()

    monkeypatch.setattr(t_registry, "flash_attention", stand_in)
    backend = t_registry.get_backend("cuda")

    def grads(fn):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*xs)
        return torch.autograd.grad(torch.sum(torch.square(out)), xs)

    got = grads(lambda q, k, v: backend.attention(q, k, v, causal=True,
                                                  window=window))
    assert launched == [(1, 2, sq, 16)]
    plain = grads(lambda q, k, v: t_ref.flash_attention(q, k, v, causal=True,
                                                        window=window))
    jnp = jx.jnp
    exp = jx.jax.grad(
        lambda q, k, v: jnp.sum(jnp.square(jx.ops.attention(
            q, k, v, causal=True, window=window, bq=16, bk=16))),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, p, e in zip(got, plain, exp):
        assert float(torch.abs(g).max()) > 0
        np.testing.assert_allclose(_f32(g), _f32(p), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_f32(g), np.asarray(e), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(jx, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 24, 16)).astype(np.float32)
    pos3 = rng.integers(0, 5000, (3, 2, 24)).astype(np.int32)
    assert (pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()
    jd = getattr(jx.jnp, dtype)
    exp = jx.rope.apply_mrope(jx.jnp.asarray(x, jd), jx.jnp.asarray(pos3),
                              1_000_000.0, (2, 3, 3))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = t_rope.apply_mrope(tx, torch.from_numpy(pos3), 1_000_000.0,
                             (2, 3, 3))
    assert out.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(exp), atol=1e-6, rtol=1e-6)
    else:   # one bf16 rounding of the same float32 rotation
        np.testing.assert_array_equal(_f32(out), _f32(exp))
    # degenerate ids (equal rows): M-RoPE is RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_array_equal(
        _f32(t_rope.apply_mrope(tx, torch.from_numpy(same), 1e6, (2, 3, 3))),
        _f32(t_rope.apply_rope(tx, torch.from_numpy(same[0]), 1e6)))
    with pytest.raises(ValueError, match="sections"):
        t_rope.apply_mrope(tx, torch.from_numpy(pos3), 1e6, (2, 3, 2))


# ---------------------------------------------------------------------------
# VLM and audio: forward, prefill and decode
# ---------------------------------------------------------------------------

def _grid_batch(cfg, rng, b: int, s: int, extra: int) -> dict:
    """Inputs of s + extra positions; for M-RoPE the first s carry an
    image grid (4 text, a 4 x 4 grid, 4 text) and position s + j the ids
    (s + j) x 3, which decode gives the token it rotates at pos s + j."""
    batch = _inputs(cfg, rng, b, s + extra)
    if cfg.rope_kind == "mrope":
        ids = image_grid_ids(b, 4, 4, 4, s - 20)
        tail = np.broadcast_to(np.arange(s, s + extra, dtype=np.int32),
                               (3, b, extra))
        batch["positions"] = np.concatenate([ids, tail], axis=2)
    return batch


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_forward_prefill_decode_match_reference(jx, arch):
    """The full forward, prefill over the first s positions and three
    decode steps after it, on both packages (qwen2-vl-2b with image-grid
    M-RoPE ids); each step also equals the port's own forward."""
    cfg = jx.registry.get_smoke(arch)
    tcfg = t_configs.get_smoke(arch)
    p = _params(jx, cfg)
    tp, jp = t_lm.params_from_numpy(p, "cpu"), _j(jx, p)
    b, s, max_len = 2, 24, 32
    batch = _grid_batch(cfg, np.random.default_rng(3), b, s, 3)
    full = t_lm.forward(tp, tcfg, _tb(batch))
    jfull = jx.lm.forward(jp, cfg, _jb(jx, batch))
    np.testing.assert_allclose(_f32(full), _f32(jfull), atol=1e-4, rtol=1e-4)
    want = (b, s + 3) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()) \
        + (cfg.vocab_size,)
    assert full.shape == want

    head = {k: (v[:, :, :s] if k == "positions" else v[:, :s])
            for k, v in batch.items()}
    logits, caches = t_lm.prefill(tp, tcfg, _tb(head), max_len)
    jlogits, jcaches = jx.lm.prefill(jp, cfg, _jb(jx, head), max_len)
    np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, s - 1]),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=1e-4,
                               rtol=1e-4)
    for t in range(s, s + 3):
        step = {k: v[:, t:t + 1] for k, v in batch.items()
                if k != "positions"}
        logits, caches = t_lm.decode_step(tp, tcfg, {**_tb(step), "pos": t},
                                          caches)
        jlogits, jcaches = jx.lm.decode_step(
            jp, cfg, {**_jb(jx, step), "pos": jx.jnp.int32(t)}, jcaches)
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, t]),
                                   atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=1e-4,
                                   rtol=1e-4)


def test_mrope_ids_reach_the_logits():
    """Image-grid ids give other logits than degenerate ids (the h and w
    rows are used), and degenerate ids equal the default positions."""
    cfg = t_configs.get_smoke("qwen2-vl-2b")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _tb(_inputs(cfg, np.random.default_rng(4), 2, 24))
    grid = torch.from_numpy(image_grid_ids(2, 4, 4, 4, 4))
    plain = torch.arange(24, dtype=torch.int32).expand(3, 2, 24)
    a = t_lm.forward(params, cfg, {**batch, "positions": grid})
    b = t_lm.forward(params, cfg, {**batch, "positions": plain})
    c = t_lm.forward(params, cfg, batch)
    torch.testing.assert_close(b, c, atol=0, rtol=0)
    # the first 4 text positions carry the same ids in both
    torch.testing.assert_close(a[:, :4], b[:, :4], atol=0, rtol=0)
    assert (a[:, 4:] - b[:, 4:]).abs().max() > 1e-3


def test_embedding_inputs_skip_the_embedding_scale():
    """The reference's ``_embed_in`` returns the projection of the
    embeddings as is: ``emb_scale`` scales token embeddings only."""
    cfg = dataclasses.replace(t_configs.get_smoke("qwen2-vl-2b"),
                              emb_scale=12.0)
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(0))
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, cfg.d_model)).astype(np.float32))
    torch.testing.assert_close(
        t_lm._embed_in(params, cfg, {"embeddings": emb}),
        emb @ params["embed_proj"], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The loss and the scanned forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_loss_fn_matches_reference(jx, arch):
    """Next-token cross entropy with −100 labels in the batch (ignored);
    float32 smoke configs."""
    cfg = jx.registry.get_smoke(arch)
    p = _params(jx, cfg)
    batch = _inputs(cfg, np.random.default_rng(5), 2, 16, labels=True)
    assert (batch["labels"] == -100).any()
    exp = jx.jax.jit(lambda q, b: jx.lm.loss_fn(q, cfg, b))(
        _j(jx, p), _jb(jx, batch))
    tp = t_lm.params_from_numpy(p, "cpu")
    got = t_lm.loss_fn(tp, t_configs.get_smoke(arch), _tb(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(exp), atol=1e-4, rtol=1e-5)
    # every label ignored: the mean over max(count, 1) gives 0
    none = dict(batch, labels=np.full_like(batch["labels"], -100))
    assert float(t_lm.loss_fn(tp, t_configs.get_smoke(arch),
                              _tb(none))) == 0.0


def _stacked(params, cfg, period):
    """The reference's scanned layout of ``params``, restacked as
    tests/test_archs.py does: p groups of nf layers, leaves with a
    leading nf axis, and the trailing layers."""
    nf = cfg.n_layers // period

    def stack(*trees):
        if isinstance(trees[0], dict):
            return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
        return np.stack(trees)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["stack"] = tuple(
        stack(*(params["layers"][j + k * period] for k in range(nf)))
        for j in range(period))
    out["trail"] = params["layers"][nf * period:]
    return out


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_forward_scanned_matches_reference_and_unrolled(jx, arch):
    """The scanned forward and loss over the restacked parameters equal
    the reference's and the port's unrolled ones; with three layers at
    period 2 both the stacked groups and a trailing layer run."""
    cfg = jx.registry.get_smoke(arch)
    tcfg = t_configs.get_smoke(arch)
    if cfg.n_layers % t_lm.pattern_period(tcfg) == 0:
        pat = cfg.pattern
        n = len(pat) + 1
        cfg = dataclasses.replace(cfg, n_layers=n, block_pattern=(
            tuple(pat[i % len(pat)] for i in range(n)) if cfg.block_pattern
            else ()))
        tcfg = dataclasses.replace(tcfg, n_layers=cfg.n_layers,
                                   block_pattern=cfg.block_pattern)
    period = t_lm.pattern_period(tcfg)
    assert period == jx.lm.pattern_period(cfg)
    p = _params(jx, cfg, seed=2)
    scanned = _stacked(p, cfg, period)
    batch = _inputs(cfg, np.random.default_rng(6), 2, 16, labels=True)
    tscan = t_lm.params_from_numpy(scanned, "cpu")
    tscan["stack"] = tuple(tscan["stack"])
    got = t_lm.forward_scanned(tscan, tcfg, _tb(batch))
    unrolled = t_lm.forward(t_lm.params_from_numpy(p, "cpu"), tcfg,
                            _tb(batch))
    exp = jx.lm.forward_scanned(_j(jx, scanned), cfg, _jb(jx, batch))
    np.testing.assert_allclose(_f32(got), _f32(unrolled), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(_f32(got), _f32(exp), atol=2e-4, rtol=2e-4)
    loss = t_lm.loss_fn_scanned(tscan, tcfg, _tb(batch), remat=True)
    jloss = jx.lm.loss_fn_scanned(_j(jx, scanned), cfg, _jb(jx, batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(
        float(loss), float(t_lm.loss_fn(t_lm.params_from_numpy(p, "cpu"),
                                        tcfg, _tb(batch))),
        atol=2e-4, rtol=2e-4)


def test_pattern_period_matches_reference(jx):
    for arch in t_configs.ARCHS:
        assert t_lm.pattern_period(t_configs.get_config(arch)) \
            == jx.lm.pattern_period(jx.registry.get_config(arch)), arch


# ---------------------------------------------------------------------------
# Serving codebooks
# ---------------------------------------------------------------------------

def test_multicodebook_generation_through_the_server():
    """Mirrors tests/test_serving.py: musicgen generation gives
    (max_new_tokens, C) tokens in range, through the Server as directly,
    and greedy equals the full forward's argmax per codebook, step by
    step; a temperature draw repeats from its seed."""
    cfg = t_configs.get_smoke("musicgen-large")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(1))
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (8, cfg.n_codebooks))
               .astype(np.int32) for _ in range(3)]
    reqs = [Request(q, max_new_tokens=4) for q in prompts]
    outs = eng.generate(reqs[:2])
    assert outs[0].shape == (4, cfg.n_codebooks) and outs[0].dtype == np.int32
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()
    for out, q in zip(outs, prompts):
        seq = torch.from_numpy(q)[None]
        for _ in range(4):
            logits = t_lm.forward(eng.params, cfg, {"tokens": seq})
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            seq = torch.cat([seq, nxt], dim=1)
        np.testing.assert_array_equal(out, seq[0, 8:].numpy())
    srv = Server(eng, SchedulerConfig(max_batch_size=2))
    tickets = [srv.submit(r) for r in reqs]
    assert srv.drain() == 3
    for r, t in zip(reqs, tickets):
        res = t.result()
        assert isinstance(res, Completed)
        np.testing.assert_array_equal(res.value, eng.generate([r])[0])
    hot = [Request(prompts[0], 4, temperature=1.5), reqs[1]]
    a, b = eng.generate(hot, seed=3), eng.generate(hot, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], outs[1])


def test_engine_refuses_embedding_inputs():
    cfg = t_configs.get_smoke("qwen2-vl-2b")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="embeddings"):
        ServeEngine(cfg, params, device="cpu")


def test_launcher_serves_codebooks_and_refuses_the_vlm(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--arch", "musicgen-large", "--num-requests",
          "2", "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "musicgen-large-smoke" in out
    with pytest.raises(SystemExit, match="needs frontend embeddings"):
        main(["--device", "cpu", "--arch", "qwen2-vl-2b"])


# ---------------------------------------------------------------------------
# The registry's shapes
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_reference(jx):
    ref = jx.registry
    assert t_configs.ARCHS == ref.ARCHS and len(t_configs.ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    assert t_configs.all_cells() == ref.all_cells()
    for arch, shape in ref.all_cells():
        assert t_configs.shape_applicable(arch, shape) \
            == ref.shape_applicable(arch, shape)
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        for ours, theirs in ((t_configs.get_config(arch),
                              ref.get_config(arch)),
                             (t_configs.get_smoke(arch), ref.get_smoke(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
