"""Batched serving example (PyTorch port): prefill + incremental decode
with per-layer caches (KV ring buffers / recurrent states), greedy and
sampled requests, across attention, hybrid (RG-LRU) and SSM (Mamba2)
architectures, at each arch's reduced (smoke) config.

    PYTHONPATH=src python examples/torch_serve_lm.py \
        --arch recurrentgemma-2b [--device cpu]

It serves on the CUDA card (prefill attention through the hand-written
kernel) unless ``--device cpu`` asks for the CPU.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_smoke
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    if cfg.input_mode != "tokens":
        print(f"{args.arch} takes frontend embeddings; serving demo uses "
              f"token archs — switching to qwen3-8b")
        cfg = get_smoke("qwen3-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params,
                      max_len=args.prompt_len + args.new_tokens + 1,
                      device=args.device)

    rng = np.random.default_rng(0)
    shape = (args.prompt_len, cfg.n_codebooks) if cfg.n_codebooks > 1 \
        else (args.prompt_len,)
    reqs = [Request(rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(args.batch)]
    t0 = time.time()
    outs = eng.generate(reqs, seed=1)
    dt = time.time() - t0
    total = sum(o.shape[0] for o in outs)
    print(f"arch={cfg.name}: served {len(reqs)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s on {eng.device})")
    for i, o in enumerate(outs):
        head = o[:8].tolist() if o.ndim == 1 else o[:4].tolist()
        print(f"  req{i} (T={reqs[i].temperature}): {head} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
