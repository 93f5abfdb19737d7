"""Fault-tolerant checkpointing.

The port of ``repro.checkpoint.manager``. Atomic rolling checkpoints:
each save writes to a temp directory and ``os.rename``s it into place
(POSIX-atomic), so a preemption mid-save can never corrupt the latest
checkpoint; a retention policy bounds disk use. Restore picks the newest
complete step.

Layout: <dir>/step_<N>/arrays.npz + meta.json. Arrays are stored flat,
keyed by their path in the tree in the port's own flat form
(``0/layers/0/w``: ``/``-joined dict keys and list positions, the form of
``Executable.save_params``); the reference keys its files by JAX's
key paths, so checkpoints do not cross between the two packages.
Restore casts each array to its template leaf's dtype and device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.runtime.executable import _flatten_params as _flatten


def _unflatten(template, arrays: dict, prefix: str = ""):
    """Rebuild ``template``'s structure from flat arrays;
    each leaf takes its template leaf's dtype and device."""
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return torch.from_numpy(np.array(arrays[prefix[:-1]])).to(
        device=template.device, dtype=template.dtype)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False          # overlap save with the next train step

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, tree, step: int) -> None:
        if self.async_save:
            self.wait()
            # a copy: a CPU tensor's numpy view would see later updates
            host = {k: a.copy() for k, a in _flatten(tree).items()}
            self._thread = threading.Thread(
                target=self._save_sync, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._save_sync(_flatten(tree), step)

    def _save_sync(self, arrays: dict, step: int) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "num_arrays": len(arrays)}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self._steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():   # complete checkpoints only
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, template, step: int):
        d = self.dir / f"step_{step:08d}"
        with np.load(d / "arrays.npz") as npz:
            arrays = dict(npz)
        return _unflatten(template, arrays)

    def restore_latest(self, template):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(template, step), step
