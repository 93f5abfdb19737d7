"""The fault-tolerant training loop.

The port of ``repro.training.train_loop.TrainLoop``: periodic and
preemption-signal (SIGTERM) checkpointing through
:class:`~repro_torch.checkpoint.manager.CheckpointManager`, deterministic
resume (the data is indexed by step, so a resumed run skips to the step
it restored) and a straggler log. The GNN trainer
(:mod:`repro_torch.runtime.fit`) hands it its train step. The
reference's ``make_train_step`` (the LM train step, its default) is LM
training, ROADMAP.md Queue 1 item 7.8, and not ported.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable


@dataclasses.dataclass
class TrainLoop:
    """Checkpoint/restart, preemption save and metrics around a train
    step ``(params, opt_state, batch) -> (params, opt_state, metrics)``."""

    data_iter: Any                       # step-indexable: data_iter(step)->batch
    ckpt_manager: Any = None             # checkpoint.manager.CheckpointManager
    ckpt_every: int = 100
    log_every: int = 10
    straggler_warn_s: float = 5.0        # log steps slower than this

    def run(self, params, opt_state, num_steps: int, *, train_step,
            start_step: int = 0, log: Callable[[str], None] = print):
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
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
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
