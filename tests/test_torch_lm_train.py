"""LM training in the port against the reference package: the train
step's gradients, metrics and update for all ten archs, int8 gradient
compression with error feedback, the TrainLoop's resume after a
preemption, and the training launcher on the CPU.

The same numpy parameters and batches (drawn by the reference, handed
over through ``repro_torch.models.lm.params_from_numpy``) go through both
packages at the SMOKE sizes, in float32. Gradients are held per leaf to
a relative norm of 1e-5. After one AdamW step an entry moves by about
``lr · g / (|g| + eps)``, so an entry whose gradient is noise-sized can
flip its step's sign between the two frameworks: the updated parameters
are held to 1e-5 where ``|g_ref| > 1e-4 · max |g_ref|`` of the leaf, and
elsewhere to the most a flipped step can move (2 lr), and counted.

JAX and the reference package are imported inside fixtures only.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as t_configs
from repro_torch.models import lm as t_lm
from repro_torch.training import compression as t_comp
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map,
                                            tree_unflatten)
from repro_torch.training.train_loop import (TrainLoop, init_train_state,
                                             make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_REL = 1e-5
LR = 1e-3


@pytest.fixture(scope="module")
def jx():
    """The reference package's training stack (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke
    from repro.models import lm
    from repro.training import compression, optimizer, train_loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke,
                                 lm=lm, compression=compression,
                                 optimizer=optimizer, train_loop=train_loop)


def _inputs(cfg, rng, b: int = 2, s: int = 16) -> dict:
    """A numpy training batch of ``cfg``'s kind (as tests/test_archs.py
    builds it), with a few labels -100."""
    tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    if cfg.input_mode == "embeddings":
        batch = {"embeddings":
                 rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens":
                 rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)}
    lab = rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)
    lab[rng.random(tshape) < 0.1] = -100
    batch["labels"] = lab
    return batch


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(jx, batch: dict) -> dict:
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _flat(jx, tree) -> list:
    """The leaves of a reference tree as numpy, in JAX's order (the
    order of the port's ``tree_leaves``)."""
    return [np.asarray(x) for x in jx.jax.tree_util.tree_leaves(tree)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_train_step_matches_reference(jx, arch):
    """One step of ``make_train_step`` (no remat, as the reference's
    test_train_step) from the same parameters and batch: per-leaf
    gradients within ``GRAD_REL``, the loss, grad_norm and lr, and the
    updated parameters and moments (masked as the module docstring
    says); the step leaves its arguments as they were."""
    cfg = jx.get_smoke(arch)
    tcfg = t_configs.get_smoke(arch)
    opt_cfg = jx.optimizer.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    t_opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    p = _np_tree(jx, jx.lm.init_params(cfg, jx.jax.random.key(1)))
    batch = _inputs(cfg, np.random.default_rng(2))
    jp, jbatch = jx.jax.tree_util.tree_map(jx.jnp.asarray, p), _jb(jx, batch)
    jstep = jx.jax.jit(jx.train_loop.make_train_step(cfg, opt_cfg,
                                                     remat=False))
    jp1, jo1, jm = jstep(jp, jx.optimizer.adamw_init(jp), jbatch)
    # the reference's gradients, read back from its first moment:
    # m = (1 - b1) · g · clip, clip = min(1, grad_clip / grad_norm)
    clip = min(1.0, opt_cfg.grad_clip / float(jm["grad_norm"]))
    jflat = [m / np.float32(1 - opt_cfg.b1) / np.float32(clip)
             for m in _flat(jx, jo1["m"])]

    tp = t_lm.params_from_numpy(p, "cpu")
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    loss = t_lm.loss_fn(tree_unflatten(tp, leaves), tcfg, _tb(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jm["loss"]),
                               rtol=1e-5)
    assert len(jflat) == len(grads)
    worst = max(_rel(g.numpy(), e) for g, e in zip(grads, jflat))
    assert worst <= GRAD_REL, worst

    before = [t.clone() for t in tree_leaves(tp)]
    tstep = make_train_step(tcfg, t_opt_cfg, remat=False)
    tp1, to1, tm = tstep(tp, adamw_init(tp), _tb(batch))
    for a, b in zip(tree_leaves(tp), before):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(to1["step"]) == int(jo1["step"]) == 1
    flipped = 0
    for got, want, g_ref in zip(tree_leaves(tp1), _flat(jx, jp1), jflat):
        got = got.numpy()
        big = np.abs(g_ref) > 1e-4 * np.abs(g_ref).max()
        np.testing.assert_allclose(got[big], want[big], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[~big], want[~big], atol=2 * LR + 1e-5)
        flipped += int((np.abs(got - want) > 1e-5)[~big].sum())
    m_rel = max(_rel(m.numpy(), e) for m, e in zip(tree_leaves(to1["m"]),
                                                     _flat(jx, jo1["m"])))
    assert m_rel <= GRAD_REL, m_rel
    total = sum(t.numel() for t in tree_leaves(tp1))
    assert flipped <= 0.01 * total, (flipped, total)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_two_steps_move_params_without_the_loss_exploding(arch, remat):
    """The reference's test_train_step, on the port: two steps from
    ``init_train_state`` move the parameters and keep the loss finite and
    below 1.5x the first; the donating step (``donate=True``) gives the
    same numbers in the same tensors."""
    cfg = t_configs.get_smoke(arch)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params, opt = init_train_state(cfg, opt_cfg,
                                   torch.Generator().manual_seed(1))
    batch = _tb(_inputs(cfg, np.random.default_rng(0)))
    step = make_train_step(cfg, opt_cfg, remat=remat)
    p1, o1, m1 = step(params, opt, batch)
    p2, o2, m2 = step(p1, o1, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(params), tree_leaves(p1)))
    assert moved > 0
    assert float(m2["loss"]) < float(m1["loss"]) * 1.5
    donating = make_train_step(cfg, opt_cfg, remat=remat, donate=True)
    d1, do1, dm1 = donating(params, opt, batch)
    assert d1["layers"][0]["ln1"] is params["layers"][0]["ln1"]
    assert float(dm1["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves((d1, do1["m"], do1["v"])),
                    tree_leaves((p1, o1["m"], o1["v"]))):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_compress_decompress_is_bitwise_the_reference(jx):
    """Three steps with error feedback on a bf16 and a float32 leaf: the
    int8 codes, the scales, the dequantized gradients and the feedback
    are bit for bit the reference's; wire_bytes_saved agrees."""
    rng = np.random.default_rng(3)
    jnp = jx.jnp
    ef_j = ef_t = None
    for step in range(3):
        g32 = (rng.standard_normal((33, 17)) * 10 ** rng.uniform(-6, 2)
               ).astype(np.float32)
        g32[0, 0] = 0.5 * np.abs(g32).max()       # a tie-prone value
        gbf = rng.standard_normal((5, 7)).astype(np.float32)
        jg = {"w": jnp.asarray(g32), "b": [jnp.asarray(gbf, jnp.bfloat16)]}
        tg = {"w": torch.from_numpy(g32),
              "b": [torch.from_numpy(gbf).to(torch.bfloat16)]}
        jq, js = jx.compression._quantize(jnp.asarray(g32))
        tq, ts = t_comp._quantize(torch.from_numpy(g32))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.dtype == torch.float32
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jd, ef_j = jx.compression.compress_decompress(jg, ef_j)
        td, ef_t = t_comp.compress_decompress(tg, ef_t)
        assert td["b"][0].dtype == torch.bfloat16
        for got, want in ((td["w"], jd["w"]), (td["b"][0], jd["b"][0]),
                          (ef_t["w"], ef_j["w"]),
                          (ef_t["b"][0], ef_j["b"][0])):
            a = got.view(torch.int16 if got.dtype == torch.bfloat16
                         else torch.int32).numpy()
            w = np.asarray(want)
            np.testing.assert_array_equal(a, w.view(a.dtype))
        assert float(ef_t["w"].abs().max()) > 0
    assert t_comp.wire_bytes_saved(tg) == jx.compression.wire_bytes_saved(jg)


def test_compressed_step_keeps_error_feedback(jx):
    """``compress_grads``: ``init_train_state`` adds a float32 zero ``ef``
    tree, a step fills it, and the step equals the reference's."""
    cfg = jx.get_smoke("qwen2-vl-2b")
    tcfg = t_configs.get_smoke("qwen2-vl-2b")
    opt_cfg = jx.optimizer.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    t_opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    _, fresh = init_train_state(tcfg, t_opt_cfg,
                                torch.Generator().manual_seed(0),
                                compress_grads=True)
    assert all(e.dtype == torch.float32 and not e.any()
               for e in tree_leaves(fresh["ef"]))
    p = _np_tree(jx, jx.lm.init_params(cfg, jx.jax.random.key(4)))
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, p)
    jopt = jx.optimizer.adamw_init(jp)
    jopt["ef"] = jx.jax.tree_util.tree_map(
        lambda a: jx.jnp.zeros(a.shape, jx.jnp.float32), jp)
    tp = t_lm.params_from_numpy(p, "cpu")
    topt = dict(adamw_init(tp), ef=tree_map(torch.zeros_like, tp))
    jstep = jx.jax.jit(jx.train_loop.make_train_step(
        cfg, opt_cfg, remat=False, compress_grads=True))
    tstep = make_train_step(tcfg, t_opt_cfg, remat=False,
                            compress_grads=True)
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = _inputs(cfg, rng)
        jp, jopt, jm = jstep(jp, jopt, _jb(jx, batch))
        tp, topt, tm = tstep(tp, topt, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert any(e.abs().max() > 0 for e in tree_leaves(topt["ef"]))
    # the feedback is the rounding residual of gradients that agree to
    # ~1e-6 relative, at most half a quantization step in size: where a
    # code rounds the other way the two residuals differ by one step, so
    # the entries are compared as codes are: all but a thousandth (3 of
    # 94,784 read)
    differ = total = 0
    for e, w in zip(tree_leaves(topt["ef"]), _flat(jx, jopt["ef"])):
        d = np.abs(e.numpy() - w)
        differ += int((d > 1e-3 * np.abs(w).max()).sum())
        total += d.size
    assert differ <= 1e-3 * total, (differ, total)


def test_resume_after_preemption(tmp_path):
    """Mirrors tests/test_training.py::test_resume_after_preemption: the
    TrainLoop builds its own step from ``cfg`` and ``opt_cfg``, saves at
    step 4, and a rerun from fresh parameters restores step 4 and
    continues to 8, with the same losses as an uninterrupted run from
    step 4 on."""
    cfg = t_configs.get_smoke("qwen2.5-3b")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    rng = np.random.default_rng(0)
    data = [{"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 16)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (2, 16)).astype(np.int32))}
            for _ in range(8)]

    def fresh(seed):
        return init_train_state(cfg, opt_cfg,
                                torch.Generator().manual_seed(seed))

    mgr = CheckpointManager(str(tmp_path), keep=2)
    loop = TrainLoop(cfg, opt_cfg, lambda s: data[s % len(data)],
                     ckpt_manager=mgr, ckpt_every=4, log_every=1)
    p1, o1, hist = loop.run(*fresh(0), 6, log=lambda *_: None)
    assert mgr.latest_step() == 4 and [s for s, _ in hist] == list(range(6))
    # "restart": fresh parameters; the loop restores step 4 and goes on
    p2, o2, hist2 = loop.run(*fresh(99), 8, log=lambda *_: None)
    assert mgr.latest_step() == 8 and int(o2["step"]) == 8
    assert [s for s, _ in hist2] == [4, 5, 6, 7]
    assert [x for _, x in hist2[:2]] == [x for _, x in hist[4:6]]


def test_checkpoint_keeps_bfloat16_bits(tmp_path):
    """bf16 leaves round-trip bit for bit (stored as their int16 bits),
    asynchronously too."""
    cfg = dataclasses.replace(t_configs.get_smoke("qwen2.5-3b"),
                              param_dtype="bfloat16")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(3))
    state = (params, adamw_init(params))
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state, 3)
    (back, opt), step = mgr.restore_latest(state)
    assert step == 3
    for a, b in zip(tree_leaves(state), tree_leaves((back, opt))):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert back["embed"].dtype == torch.bfloat16


def test_rules_and_production_meshes_raise():
    """The production meshes need their 256 / 512 ranks: without a
    process group the launcher stops with a message naming the count
    (the reference's ``mesh_from_cli`` check); rules without a
    ``DeviceMesh`` cannot lay a train state out."""
    from repro_torch.dist.shardings import ShardingRules
    from repro_torch.launch.train import main
    from repro_torch.training.train_loop import shard_train_state

    cfg = t_configs.get_smoke("qwen2.5-3b")
    rules = ShardingRules({"data": 16, "model": 16})
    params, opt = init_train_state(cfg, AdamWConfig(),
                                   torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_train_state(rules, cfg, params, opt)
    for mesh, need in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit, match=f"needs {need} devices"):
            main(["--device", "cpu", "--smoke", "--mesh", mesh])


@pytest.mark.parametrize("arch,extra", [
    ("qwen2.5-3b", []), ("qwen2-vl-2b", ["--compress-grads"]),
    ("musicgen-large", [])])
def test_train_launcher_on_cpu(tmp_path, arch, extra):
    """``launch/train.py --smoke --device cpu`` in a subprocess: exit 0,
    finite losses, a checkpoint at step 50 would be the first, so the
    directory holds none after 4 steps."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--arch", arch, "--steps", "4", "--global-batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path), *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.stdout.splitlines() if " loss " in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout
    assert f"arch={arch}-smoke" in out.stdout
