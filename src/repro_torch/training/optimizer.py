"""AdamW and its learning-rate schedules, on trees of tensors.

The port of ``repro.training.optimizer``, with its numerics: float32
moments, eps outside √v̂, b2 = 0.95 by default, decoupled weight decay on
matrices only (ndim ≥ 2), and global-norm clipping. Schedules are
constant, warmup-cosine and MiniCPM's WSD (warmup-stable-decay).
``torch.optim.AdamW`` differs on several of these, so it is not used.

A tree is a dict, list or tuple of tensors, walked as JAX walks a pytree
(dict keys sorted), so a sum over its leaves adds in the reference's
order. The update is functional: it returns new tensors and leaves its
arguments as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"         # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1          # WSD: fraction of steps in decay phase


def make_schedule(cfg: AdamWConfig) -> Schedule:
    """step (an integer tensor) -> float32 learning rate."""
    w, t = cfg.warmup_steps, cfg.total_steps

    def sched(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(w, 1)
        if cfg.schedule == "constant":
            main = torch.tensor(1.0)
        elif cfg.schedule == "cosine":
            frac = torch.clamp((s - w) / max(t - w, 1), 0.0, 1.0)
            main = 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif cfg.schedule == "wsd":
            # MiniCPM: a constant ("stable") phase, then exponential-ish
            # decay over the final decay_frac of training
            decay_start = t * (1.0 - cfg.decay_frac)
            frac = torch.clamp((s - decay_start) / max(t - decay_start, 1),
                               0.0, 1.0)
            main = torch.where(s < decay_start, 1.0, 0.5 ** (frac * 10.0))
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * torch.clamp(warm, max=1.0) * main

    return sched


def adamw_init(params) -> dict:
    """Zero float32 moments beside each parameter (laid out as it is: a
    DTensor parameter's moments are DTensors of its placements); the step
    count (an int32 scalar on the host) at 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 schedule: Schedule | None = None, *, donate: bool = False):
    """Returns (new_params, new_opt_state, stats). With ``donate`` the new
    parameters and moments are written into the tensors of ``params``
    and ``opt_state`` (the same numbers, computed one leaf at a time),
    which are returned: the counterpart of the reference's jit with
    ``donate_argnums``, so a step holds one copy of the moments."""
    sched = schedule or make_schedule(cfg)
    step = opt_state["step"] + 1
    lr = sched(step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip > 0 else 1.0

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2 and cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m, v

    def upd_into(p, g, m, v):
        for old, new in zip((p, m, v), upd(p, g, m, v)):
            old.copy_(new)
        return p, m, v

    out = [(upd_into if donate else upd)(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_params, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                                for i in range(3))
    stats = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, stats
