"""End-to-end LM training driver (PyTorch port): trains a reduced config
of any assigned architecture for a few hundred steps with the full
production substrate — AdamW + schedule, atomic rolling checkpoints,
resume after preemption, optional int8 gradient compression.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2.5-3b \
        --steps 300 --d-model 256 --layers 4 [--device cpu]

The data is a synthetic structured stream (a 1st-order Markov chain), so
the loss has real signal to descend — final loss far below the uniform
log(V) floor demonstrates the whole stack learns. It trains on the CUDA
card (attention through the hand-written kernel) unless ``--device cpu``
asks for the CPU. Checkpoints go to ``--ckpt-dir`` (default: a directory
under the system's temporary directory); rerunning the same command
resumes from the latest one.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_smoke
from repro_torch.models import lm
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (TrainLoop, init_train_state,
                                             make_train_step)


def markov_batches(vocab: int, batch: int, seq: int, device,
                   seed: int = 0):
    """Deterministic-by-step synthetic data with learnable structure
    (1st-order Markov chain + 10% noise: optimal loss ≈ 0.1·log V)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab, (vocab,)).astype(np.int32)

    def at(step: int):
        r = np.random.default_rng(seed * 7919 + step)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = r.integers(0, vocab, batch)
        noise = r.random((batch, seq + 1)) < 0.1
        for t in range(1, seq + 1):
            toks[:, t] = table[toks[:, t - 1]]
            flip = noise[:, t]
            toks[flip, t] = r.integers(0, vocab, int(flip.sum()))
        toks = torch.from_numpy(toks).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return at


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd", choices=["cosine", "wsd",
                                                          "constant"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_smoke(args.arch)
    # scale the smoke config up to the requested size
    period = lm.pattern_period(cfg)
    layers = max(period, (args.layers // period) * period)
    pat = tuple(cfg.pattern[i % period] for i in range(layers)) \
        if cfg.block_pattern else ()
    cfg = dataclasses.replace(cfg, n_layers=layers, block_pattern=pat,
                              d_model=args.d_model,
                              d_ff=args.d_model * 3)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params={cfg.num_params()/1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=args.lr, schedule=args.schedule,
                          warmup_steps=max(10, args.steps // 20),
                          total_steps=args.steps)
    params, opt_state = init_train_state(
        cfg, opt_cfg, torch.Generator(device).manual_seed(0),
        compress_grads=args.compress_grads)

    data = markov_batches(cfg.vocab_size, args.batch, args.seq, device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    loop = TrainLoop(cfg, opt_cfg, data, ckpt_manager=mgr,
                     ckpt_every=args.ckpt_every, log_every=10)
    step_fn = make_train_step(cfg, opt_cfg, remat=False,
                              compress_grads=args.compress_grads,
                              donate=True)
    params, opt_state, losses = loop.run(params, opt_state, args.steps,
                                         train_step=step_fn)
    mgr.wait()
    first, last = losses[0][1], losses[-1][1]
    uniform = float(np.log(cfg.vocab_size))
    print(f"\nloss: {first:.3f} -> {last:.3f} (uniform floor {uniform:.3f})")
    assert last < first, "training did not reduce loss"
    return 0


if __name__ == "__main__":
    sys.exit(main())
