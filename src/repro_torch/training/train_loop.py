"""Train-step construction and the fault-tolerant training loop.

The port of ``repro.training.train_loop``. :func:`make_train_step` builds
the LM's ``(params, opt_state, batch) -> (params, opt_state, metrics)``
step: the gradient of ``models.lm.loss_fn`` by autograd (through the
kernel registry's attention, whose backward is autograd of the plain
version), optional int8 gradient compression with error feedback
(``training/compression.py``), then AdamW. With sharding rules
(``dist/shardings.py``) the step runs on DTensors: the parameters and
moments laid out by ``rules.tree_shardings``, the batch by its input
axes, the activations constrained by ``rules.constrain``.

:class:`TrainLoop` adds the production concerns: periodic and
preemption-signal (SIGTERM) checkpointing through
:class:`~repro_torch.checkpoint.manager.CheckpointManager`, deterministic
resume (the data is indexed by step, so a resumed run skips to the step
it restored) and a straggler log. The GNN trainer
(:mod:`repro_torch.runtime.fit`) hands it its own train step.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Axes, init_leaf
from repro_torch.training.compression import compress_decompress
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, make_schedule,
                                            tree_leaves, tree_map,
                                            tree_unflatten)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, rules=None, *,
                    remat: bool = True, compress_grads: bool = False,
                    barrier_grads: bool = True, backend=None,
                    donate: bool = False,
                    loss_fn: Callable = lm.loss_fn) -> Callable:
    """The LM train step. ``remat`` recomputes each layer's activations in
    the backward; ``backend`` is the kernel backend of the attention
    (``cuda`` by default, or ``reference``); ``loss_fn`` is
    ``lm.loss_fn``, or ``lm.loss_fn_scanned`` for stacked parameters.

    With ``rules`` (a :class:`~repro_torch.dist.shardings.ShardingRules`
    on a ``DeviceMesh``) the parameters and optimizer moments are
    DTensors laid out by ``rules`` (:func:`shard_train_state`); the
    step lays the batch's plain tensors out by their input axes, runs
    the loss with ``constrain=rules.constrain`` (tensors the model makes
    itself, such as positions and masks, count as replicated),
    redistributes each gradient to its parameter's layout (the
    data-parallel reduction) and returns the metrics as plain tensors.

    The step leaves its arguments as they were and returns new parameter
    and optimizer trees; with ``donate`` it writes the new parameters and
    moments into the given ones instead (the counterpart of the
    reference's jit with ``donate_argnums=(0, 1)``: one copy of the
    float32 moments on the device)."""
    # barrier_grads keeps XLA from hoisting the optimizer's float32 upcast
    # above the gradient all-reduce; eager PyTorch reorders nothing, so it
    # is accepted and has no effect
    del barrier_grads
    schedule = make_schedule(opt_cfg)
    constrain = rules.constrain if rules is not None else (lambda x, a: x)

    def step(params, opt_state, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                           constrain=constrain, remat=remat,
                           backend=backend)
            grads = torch.autograd.grad(loss, leaves)
        if rules is not None:   # the data-parallel reduction
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        grads = tree_unflatten(params, list(grads))
        loss = loss.detach()
        opt_state = dict(opt_state)
        ef = opt_state.pop("ef", None)
        if compress_grads:
            grads, ef = compress_decompress(grads, ef)
        new_params, new_opt, stats = adamw_update(grads, opt_state, params,
                                                  opt_cfg, schedule,
                                                  donate=donate)
        if ef is not None:
            new_opt["ef"] = ef
        return new_params, new_opt, {"loss": loss, **stats}

    if rules is None:
        return step

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.inputs import batch_axes

    def sharded_step(params, opt_state, batch):
        batch = rules.distribute(batch, batch_axes(cfg, batch))
        with implicit_replication():
            new_params, new_opt, metrics = step(params, opt_state, batch)
        return new_params, new_opt, {
            k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}

    return sharded_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     gen: torch.Generator, compress_grads: bool = False,
                     rules=None):
    """(params, opt_state) on ``gen.device``: parameters drawn from
    ``gen``, AdamW's zero moments and, with ``compress_grads``, a float32
    zero error-feedback tree ``"ef"``. With ``rules`` (on a
    ``DeviceMesh``) each parameter is laid out by them as soon as it is
    drawn, keeping only this rank's shards, and the moments are made as
    shards: no rank holds the whole state, only one whole leaf at a
    time. The draws are the unsharded ones."""
    leaf = init_leaf(gen, cfg.pdtype)
    if rules is not None:
        draw = leaf

        def leaf(name, shape, axes, **kw):
            return rules.distribute(draw(name, shape, axes, **kw),
                                    Axes(tuple(axes)))

    params = lm.param_struct(cfg, leaf)
    opt_state = adamw_init(params)
    if compress_grads:
        opt_state["ef"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return params, opt_state


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) as meta tensors: the dry-run's stand-ins."""
    params = lm.abstract_params(cfg)

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    opt_state = {"m": tree_map(f32, params), "v": tree_map(f32, params),
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
    return params, opt_state


def train_state_axes(cfg: ModelConfig):
    """The logical-axes trees matching :func:`abstract_train_state`."""
    axes = lm.param_axes(cfg)
    return axes, {"m": axes, "v": axes, "step": Axes(())}


def shard_train_state(rules, cfg: ModelConfig, params, opt_state):
    """(params, opt_state) as DTensors laid out by ``rules``: the
    parameters, moments and error feedback by the parameters' axes. The
    step count stays the host tensor it is (a replicated scalar)."""
    axes = lm.param_axes(cfg)
    opt = {k: v for k, v in opt_state.items() if k != "step"}
    return (rules.distribute(params, axes),
            dict(rules.distribute(opt, {k: axes for k in opt}),
                 step=opt_state["step"]))


@dataclasses.dataclass
class TrainLoop:
    """Checkpoint/restart, preemption save and metrics around a train
    step ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``cfg``/``opt_cfg`` may be None when an explicit ``train_step`` is
    passed to :meth:`run` — the GNN path (runtime/fit.py) builds its own
    step and borrows only the loop mechanics. Without one, :meth:`run`
    builds :func:`make_train_step` (``cfg``, ``opt_cfg``)."""

    cfg: ModelConfig | None
    opt_cfg: AdamWConfig | None
    data_iter: Any                       # step-indexable: data_iter(step)->batch
    ckpt_manager: Any = None             # checkpoint.manager.CheckpointManager
    ckpt_every: int = 100
    log_every: int = 10
    straggler_warn_s: float = 5.0        # log steps slower than this

    def run(self, params, opt_state, num_steps: int, *, train_step=None,
            start_step: int = 0, log: Callable[[str], None] = print):
        step_fn = train_step or make_train_step(self.cfg, self.opt_cfg,
                                                donate=True)

        # resume: restore latest checkpoint if present
        if self.ckpt_manager is not None:
            restored = self.ckpt_manager.restore_latest((params, opt_state))
            if restored is not None:
                (params, opt_state), start_step = restored
                log(f"[resume] restored checkpoint at step {start_step}")

        preempted = {"flag": False}

        def _on_signal(signum, frame):  # graceful preemption save
            preempted["flag"] = True

        # signal handlers can only be installed from the main thread
        on_main = threading.current_thread() is threading.main_thread()
        old = signal.signal(signal.SIGTERM, _on_signal) if on_main else None
        losses = []
        try:
            t_prev = time.monotonic()
            for step in range(start_step, num_steps):
                batch = self.data_iter(step)   # deterministic by step => resume-safe
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                if step % self.log_every == 0 or step == num_steps - 1:
                    loss = float(metrics["loss"])
                    losses.append((step, loss))
                    dt = time.monotonic() - t_prev
                    log(f"step {step:5d} loss {loss:.4f} "
                        f"lr {float(metrics['lr']):.2e} {dt:.2f}s")
                    if dt > self.straggler_warn_s:
                        log(f"[straggler] step {step} took {dt:.2f}s")
                t_prev = time.monotonic()
                if self.ckpt_manager is not None and (
                        (step + 1) % self.ckpt_every == 0 or preempted["flag"]):
                    self.ckpt_manager.save((params, opt_state), step + 1)
                    if preempted["flag"]:
                        log(f"[preempt] checkpoint saved at step {step + 1}")
                        break
        finally:
            if on_main:
                signal.signal(signal.SIGTERM, old)
        return params, opt_state, losses
