"""One rank of the four-process sharded train step that
``tests/test_torch_sharded_train.py`` spawns: gloo on the CPU, a data 2 x
model 2 ``DeviceMesh`` and then a data 1 x model 4 one, one
``make_train_step(rules=...)`` step per case from the numpy parameters
and batch the test hands over, with remat and donation as the launcher
runs it (and int8 gradient compression where the case asks). Imports the
port only (no JAX)."""
import datetime

import torch
import torch.distributed as dist


def run_case(mesh, arch: str, params: dict, batch: dict,
             compress: bool) -> dict:
    """One sharded float32 smoke step: the loss, the new parameters, the
    first moments and (``compress``) the error feedback, gathered
    whole."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.dist.shardings import ShardingRules
    from repro_torch.models import lm
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_loop import (make_train_step,
                                                 shard_train_state)

    cfg = get_smoke(arch)
    rules = ShardingRules(mesh)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p = lm.params_from_numpy(params, "cpu")
    o = adamw_init(p)
    if compress:
        o["ef"] = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                           p)
    p, o = shard_train_state(rules, cfg, p, o)
    step = make_train_step(cfg, opt_cfg, rules, remat=True, donate=True,
                           compress_grads=compress)
    p1, o1, m = step(p, o, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert all(a is b for a, b in zip(tree_leaves(p1), tree_leaves(p)))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": [t.full_tensor().numpy() for t in tree_leaves(p1)],
           "m": [t.full_tensor().numpy() for t in tree_leaves(o1["m"])]}
    if compress:
        out["ef"] = [t.full_tensor().numpy() for t in tree_leaves(o1["ef"])]
    return out


def sharded_draw(mesh, arch: str) -> bool:
    """``init_train_state(rules=...)`` keeps each rank's shards of the
    unsharded draw, each in a storage of its own size (the full leaf is
    freed), with moments of the same layout."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.dist.shardings import ShardingRules
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import (init_train_state,
                                                 shard_train_state)

    cfg = get_smoke(arch)
    rules = ShardingRules(mesh)
    opt_cfg = AdamWConfig()
    p, o = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(0),
                            compress_grads=True, rules=rules)
    wp, wo = shard_train_state(rules, cfg, *init_train_state(
        cfg, opt_cfg, torch.Generator().manual_seed(0), compress_grads=True))
    split = 0
    for got, want in zip(tree_leaves((p, o["m"], o["v"], o["ef"])),
                         tree_leaves((wp, wo["m"], wo["v"], wo["ef"]))):
        local = got.to_local()
        assert got.placements == want.placements
        assert torch.equal(local, want.to_local())
        assert local.untyped_storage().nbytes() \
            == local.numel() * local.element_size()
        split += got.numel() > local.numel()
    return split > 0


def worker(rank: int, world: int, store_path: str, cases: dict,
           queue) -> None:
    """Rank ``rank``: every case of ``cases`` ({(n_data, n_model):
    [(arch, params, batch, compress), ...]}) on its mesh, and the sharded
    draw of each arch; rank 0 puts the results on ``queue``."""
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for shape, runs in cases.items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for arch, params, batch, compress in runs:
                out[shape, arch, compress] = run_case(mesh, arch, params,
                                                      batch, compress)
                out[shape, arch, "draw"] = sharded_draw(mesh, arch)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()
