"""Train-step construction and the fault-tolerant training loop.

The port of ``repro.training.train_loop``. :func:`make_train_step` builds
the LM's ``(params, opt_state, batch) -> (params, opt_state, metrics)``
step: the gradient of ``models.lm.loss_fn`` by autograd (through the
kernel registry's attention, whose backward is autograd of the plain
version), optional int8 gradient compression with error feedback
(``training/compression.py``), then AdamW.

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
from repro_torch.training.compression import compress_decompress
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, make_schedule,
                                            tree_leaves, tree_map,
                                            tree_unflatten)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, rules=None, *,
                    remat: bool = True, compress_grads: bool = False,
                    barrier_grads: bool = True, backend=None,
                    donate: bool = False) -> Callable:
    """The LM train step. ``remat`` recomputes each layer's activations in
    the backward; ``backend`` is the kernel backend of the attention
    (``cuda`` by default, or ``reference``). ``rules`` (a sharding rule
    set) must be None: sharded training is ROADMAP.md Queue 1 item 7.9.

    The step leaves its arguments as they were and returns new parameter
    and optimizer trees; with ``donate`` it writes the new parameters and
    moments into the given ones instead (the counterpart of the
    reference's jit with ``donate_argnums=(0, 1)``: one copy of the
    float32 moments on the device)."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules for the train step are not ported yet "
            "(ROADMAP.md, Queue 1 item 7.9: dist/shardings.py)")
    # barrier_grads keeps XLA from hoisting the optimizer's float32 upcast
    # above the gradient all-reduce; eager PyTorch reorders nothing, so it
    # is accepted and has no effect
    del barrier_grads
    schedule = make_schedule(opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                              remat=remat, backend=backend)
            grads = torch.autograd.grad(loss, leaves)
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

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     gen: torch.Generator, compress_grads: bool = False):
    """(params, opt_state) on ``gen.device``: parameters drawn from
    ``gen``, AdamW's zero moments and, with ``compress_grads``, a float32
    zero error-feedback tree ``"ef"``."""
    params = lm.init_params(cfg, gen)
    opt_state = adamw_init(params)
    if compress_grads:
        opt_state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return params, opt_state


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
