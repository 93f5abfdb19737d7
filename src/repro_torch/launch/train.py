"""LM training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 100 [--smoke] [--compress-grads]

Runs the fault-tolerant :class:`~repro_torch.training.train_loop.TrainLoop`
on one device (``--device``, the card unless the caller names another)
with random weights drawn from seed 0 and random token batches indexed by
step, checkpointing to ``--ckpt-dir`` every 50 steps: interrupt a run,
rerun the same command, and it continues from the latest checkpoint.
``--smoke`` trains the arch's reduced config without remat. On the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --smoke --arch qwen2-vl-2b --steps 3 --compress-grads

``--mesh host`` (the default) is the one device. ``single`` and
``multi`` build the reference's production mesh (256 or 512 ranks,
``launch/mesh.py::make_production_mesh``) over the process group that
``torchrun`` describes, lay the train state out by
``dist/shardings.py``'s rules (DTensors: each rank draws every leaf from
the seed, keeps its shards and frees the rest, so no rank holds more
than its shards and one whole leaf) and run the same loop; rank 0
writes the checkpoints. One process a card, e.g. on 32 hosts of 8::

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch qwen3-8b --mesh single --steps 100
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, no remat")
    ap.add_argument("--mesh", default="host",
                    choices=["single", "multi", "host"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.runtime.api import resolve_device
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves
    from repro_torch.training.train_loop import (TrainLoop, init_train_state,
                                                 make_train_step)

    rules = None
    if args.mesh in ("single", "multi"):
        import torch.distributed as dist

        from repro_torch.dist.shardings import ShardingRules
        from repro_torch.launch.mesh import make_production_mesh

        if args.device in (None, "cuda"):   # torchrun's card for this rank
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(args.device)
    if args.mesh in ("single", "multi"):
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            dist.init_process_group(        # from torchrun's environment
                "nccl" if device.type == "cuda" else "gloo")
        rules = ShardingRules(make_production_mesh(
            multi_pod=args.mesh == "multi", device_type=device.type))
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=args.schedule,
                          warmup_steps=max(5, args.steps // 20),
                          total_steps=args.steps)

    params, opt_state = init_train_state(
        cfg, opt_cfg, torch.Generator(device).manual_seed(0),
        compress_grads=args.compress_grads, rules=rules)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"mesh={args.mesh} steps={args.steps} device={device}")

    # the reference's data: labels from default_rng(step); a VLM's
    # embeddings from one default_rng(0) advanced per call
    rng = np.random.default_rng(0)

    def data(step: int):
        r = np.random.default_rng(step)
        shape = (args.global_batch, args.seq)
        if cfg.n_codebooks > 1:
            shape += (cfg.n_codebooks,)
        toks = r.integers(0, cfg.vocab_size, shape)
        batch = {"labels": torch.from_numpy(toks.astype(np.int32)).to(device)}
        if cfg.input_mode == "embeddings":
            emb = rng.standard_normal((args.global_batch, args.seq,
                                       cfg.d_model))
            batch["embeddings"] = torch.from_numpy(emb).to(
                device=device, dtype=cfg.cdtype)
        else:
            batch["tokens"] = batch["labels"]
        return batch

    step_fn = make_train_step(cfg, opt_cfg, rules, remat=not args.smoke,
                              compress_grads=args.compress_grads,
                              donate=True)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
    loop = TrainLoop(cfg, opt_cfg, data, ckpt_manager=mgr, ckpt_every=50)
    loop.run(params, opt_state, args.steps, train_step=step_fn)
    mgr.wait()


if __name__ == "__main__":
    main()
