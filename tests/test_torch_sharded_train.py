"""``make_train_step(rules=...)``: the train step on DTensors laid out by
the sharding rules.

* On a 1 x 1 gloo mesh every placement is ``Replicate`` and the sharded
  step is bit for bit the unsharded one (two steps, int8 gradient
  compression and donation on), for all ten archs.
* Four spawned gloo processes (``tests/torch_sharded_worker.py``) run a
  float32 smoke step, with remat and donation as the launcher does, on a
  data 2 x model 2 mesh (dense GQA with kv heads split, the same with
  int8 gradient compression, RG-LRU with MQA local attention, MoE, SSD)
  and on a data 1 x model 4 mesh (command-r's 8 q / 2 kv heads: the kv
  heads stay whole and each shard reads its q heads' kv head). Each is
  held to the port's single-process step and to the reference's jitted
  step (remat and compression alike) from the same numpy parameters and
  batch: the loss and the first moments (the gradients) to a relative
  1e-5; the updated parameters to 1e-5 where the reference's gradient is
  above 1e-4 of its leaf's largest, and elsewhere to 2 lr (an AdamW step
  of a noise-sized gradient can flip its sign:
  ``tests/test_torch_lm_train.py``'s rule). With compression the moments,
  parameters are held entry by entry to 1e-5 of their leaf's largest
  but for at most a thousandth of the entries, where an int8 code of
  gradients that agree to ~1e-6 rounds the other way, the error feedback
  (a rounding residual, half a code at most) so to 1e-3 (that file's
  rule for it), and the gradient norm to 1e-5.
* On the same meshes ``init_train_state(rules=...)`` keeps each rank's
  shards of the unsharded draw, each in a storage of its own size.
* ``local_kv_heads`` gives each shard its q heads' kv heads in every case
  of the split (whole groups, part of one group, groups that straddle).
* ``launch/train.py --mesh single|multi`` runs its loop on a fake process
  group of 256 / 512 ranks (the path only: fake collectives move
  nothing).

JAX and the reference package are imported inside fixtures only.
"""
import multiprocessing
import queue as queue_mod
import types

import numpy as np
import pytest
import torch

import torch_sharded_worker
from repro_torch.configs import registry as t_configs
from repro_torch.models import lm as t_lm
from repro_torch.dist.sharded_ops import local_kv_heads
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map)
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             shard_train_state)

LR = 1e-3
REL = 1e-5
# mesh -> (arch, int8 gradient compression)
CASES = {(2, 2): (("qwen2.5-3b", False), ("qwen2.5-3b", True),
                  ("recurrentgemma-2b", False), ("qwen2-moe-a2.7b", False),
                  ("mamba2-1.3b", False)),
         (1, 4): (("command-r-plus-104b", False),)}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke
    from repro.models import lm
    from repro.training import optimizer, train_loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke,
                                 lm=lm, optimizer=optimizer,
                                 train_loop=train_loop)


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group, torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(cfg, rng, b: int = 2, s: int = 16) -> dict:
    tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    labels = rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)
    labels[rng.random(tshape) < 0.1] = -100
    batch = {"labels": labels}
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = np.where(labels < 0, 0, labels).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_one_rank_mesh_is_bitwise(world1, arch):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.shardings import ShardingRules

    rules = ShardingRules(init_device_mesh("cpu", (1, 1),
                                           mesh_dim_names=("data", "model")))
    cfg = t_configs.get_smoke(arch)
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)

    def fresh():
        return init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                compress_grads=True)

    p0, o0 = fresh()
    p1, o1 = shard_train_state(rules, cfg, *fresh())
    plain = make_train_step(cfg, opt, compress_grads=True)
    sharded = make_train_step(cfg, opt, rules, compress_grads=True,
                              donate=True)
    for step in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 _batch(cfg, np.random.default_rng(step)).items()}
        p0, o0, m0 = plain(p0, o0, batch)
        p1, o1, m1 = sharded(p1, o1, batch)
        assert torch.equal(m0["loss"], m1["loss"])
        assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(tree_leaves((p0, o0)), tree_leaves((p1, o1))):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        assert torch.equal(a, b)


def _reference_step(jx, arch, params, batch, compress) -> dict:
    cfg = jx.get_smoke(arch)
    opt = jx.optimizer.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, params)
    jo = jx.optimizer.adamw_init(jp)
    if compress:
        jo["ef"] = jx.jax.tree_util.tree_map(
            lambda a: jx.jnp.zeros(a.shape, jx.jnp.float32), jp)
    step = jx.jax.jit(jx.train_loop.make_train_step(
        cfg, opt, remat=True, compress_grads=compress))
    p1, o1, m = step(jp, jo, {k: jx.jnp.asarray(v) for k, v in batch.items()})
    leaves = jx.jax.tree_util.tree_leaves
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": [np.asarray(x) for x in leaves(p1)],
           "m": [np.asarray(x) for x in leaves(o1["m"])]}
    if compress:
        out["ef"] = [np.asarray(x) for x in leaves(o1["ef"])]
    return out


def _port_step(arch, params, batch, compress) -> dict:
    cfg = t_configs.get_smoke(arch)
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    p = t_lm.params_from_numpy(params, "cpu")
    o = adamw_init(p)
    if compress:
        o["ef"] = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                           p)
    p1, o1, m = make_train_step(cfg, opt, remat=True, donate=True,
                                compress_grads=compress)(
        p, o, {k: torch.from_numpy(v) for k, v in batch.items()})
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": [t.numpy() for t in tree_leaves(p1)],
           "m": [t.numpy() for t in tree_leaves(o1["m"])]}
    if compress:
        out["ef"] = [t.numpy() for t in tree_leaves(o1["ef"])]
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_same_codes(got: list, want: list, what: str,
                       tol: float = REL) -> None:
    """Entry by entry within ``tol`` of the leaf's largest, but for at
    most a thousandth of all entries (int8 codes that round the other
    way)."""
    differ = total = 0
    for g, w in zip(got, want, strict=True):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        differ += int((d > tol * np.abs(w).max(initial=0.0)).sum())
        total += d.size
    assert differ <= 1e-3 * total, (what, differ, total)


def _assert_same_step(got: dict, want: dict, what: str) -> None:
    assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"]), what
    assert abs(got["grad_norm"] - want["grad_norm"]) \
        <= REL * abs(want["grad_norm"]), what
    assert len(got["m"]) == len(want["m"]) == len(got["params"])
    if "ef" in want:
        for key in ("m", "params"):
            _assert_same_codes(got[key], want[key], (what, key))
        # the feedback is the rounding residual g - deq(q(g)), at most half
        # a code (amax / 254) in size, so a gradient's error relative to
        # amax is ~254 times larger relative to the feedback's largest:
        # held as tests/test_torch_lm_train.py holds it, to 1e-3
        _assert_same_codes(got["ef"], want["ef"], (what, "ef"), 1e-3)
        return
    for i, (g, w) in enumerate(zip(got["m"], want["m"])):
        assert _rel(g, w) <= REL, (what, "m", i, _rel(g, w))
    for i, (g, w, mw) in enumerate(zip(got["params"], want["params"],
                                       want["m"])):
        big = np.abs(mw) > 1e-4 * np.abs(mw).max()
        err = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert err[big].max(initial=0.0) <= REL, (what, "params", i)
        assert err.max(initial=0.0) <= 2 * LR, (what, "params", i)


def spawn_sharded_steps(tmp_path, cases: dict) -> tuple:
    """Start ``torch_sharded_worker.worker`` in four spawned processes.
    Returns (processes, queue)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store4")
    procs = [ctx.Process(target=torch_sharded_worker.worker,
                         args=(rank, 4, store, cases, results), daemon=True)
             for rank in range(4)]
    for p in procs:
        p.start()
    return procs, results


def collect(procs, results) -> dict:
    """Rank 0's results; every wait has a timeout and the children are
    killed after it, so a hang fails the caller."""
    try:
        got = results.get(timeout=240)     # drained before the joins
    except queue_mod.Empty:
        got = None
    finally:
        for p in procs:
            p.join(timeout=60)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(timeout=10)
    assert got is not None, "rank 0 returned nothing"
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return got


def test_four_rank_meshes_match_unsharded_and_reference(jx, tmp_path):
    inputs = {}
    for shape, runs in CASES.items():
        for i, (arch, compress) in enumerate(runs):
            cfg = jx.get_smoke(arch)
            params = jx.jax.tree_util.tree_map(
                np.asarray, jx.lm.init_params(cfg, jx.jax.random.key(i)))
            inputs[shape, arch, compress] = (
                params, _batch(cfg, np.random.default_rng(i)))
    cases = {shape: [(arch, *inputs[shape, arch, compress], compress)
                     for arch, compress in runs]
             for shape, runs in CASES.items()}
    procs, results = spawn_sharded_steps(tmp_path, cases)
    # the unsharded steps run here while the four ranks work
    want = {key: (_port_step(key[1], *inp, key[2]),
                  _reference_step(jx, key[1], *inp, key[2]))
            for key, inp in inputs.items()}
    got = collect(procs, results)
    draws = {key: got.pop(key) for key in list(got) if key[2] == "draw"}
    assert draws == {(shape, arch, "draw"): True
                     for shape, arch, _ in inputs}
    assert set(got) == set(want)
    for key, (port, ref) in want.items():
        _assert_same_step(got[key], port, f"{key} vs the port's unsharded")
        _assert_same_step(got[key], ref, f"{key} vs the reference")


@pytest.mark.parametrize("hq,hkv,n_model", [
    (8, 2, 2),     # whole groups: 4 q heads read kv heads 2m, 2m+1
    (8, 2, 4),     # part of one group: 2 q heads share one kv head
    (12, 3, 2),    # groups of 4 straddle shards of 6 q heads
    (4, 1, 2)])    # MQA
def test_local_kv_heads(hq, hkv, n_model):
    """Each shard's local GQA attention reads, for local q head i, the kv
    head its global q head reads, in a contiguous tensor."""
    g, hl = hq // hkv, hq // n_model
    kv = torch.arange(hkv, dtype=torch.float32).reshape(1, hkv, 1, 1) \
        .expand(2, hkv, 3, 4).contiguous()
    for m in range(n_model):
        local = local_kv_heads(kv, hl, g, m)
        assert local.is_contiguous()   # the kernel takes no strides
        per_q = hl // local.shape[1]
        assert hl % local.shape[1] == 0
        for i in range(hl):
            assert int(local[0, i // per_q, 0, 0]) == (m * hl + i) // g


@pytest.mark.parametrize("mesh,world", [("single", 256), ("multi", 512)])
def test_train_launcher_on_a_fake_production_mesh(tmp_path, capsys, mesh,
                                                  world):
    """``launch/train.py --mesh single|multi`` builds the production mesh
    over an existing process group of its size, shards the smoke train
    state and runs the loop (a fake group: its collectives move nothing,
    so only the path is checked, not the numbers)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.train import main

    dryrun._fake_group(world)
    try:
        main(["--device", "cpu", "--smoke", "--mesh", mesh, "--steps", "2",
              "--global-batch", "32", "--seq", "16",
              "--ckpt-dir", str(tmp_path)])
    finally:
        dist.destroy_process_group()
    out = capsys.readouterr().out
    assert f"mesh={mesh}" in out
    assert "step     0 loss" in out and "step     1 loss" in out
