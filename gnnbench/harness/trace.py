"""The device trace of a window: ``torch.profiler`` over the CUDA
activity alone, reduced to the device's operations, its busy time and
its idle gaps.

The profiler's chrome trace stamps events on the wall clock
(``baseTimeNanoseconds`` plus ``ts`` in microseconds); they are moved to
the ``time.perf_counter`` clock the driver stamps its spans on, by the
offset between the two clocks read when the trace starts.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    names: list[str]            # per operation
    start: np.ndarray           # (ops,) s on the perf_counter clock
    dur: np.ndarray             # (ops,) s
    t0: float                   # the traced window, perf_counter clock
    t1: float
    cats: list[str] | None = None   # per operation: kernel, gpu_memcpy, ...

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self, clip: bool = False) -> np.ndarray:
        """(k, 2) merged [start, end) intervals with an operation running
        (every operation in the trace ran inside the window; ``clip``
        clips them to it on the perf_counter clock)."""
        if not len(self.start):
            return np.empty((0, 2))
        order = np.argsort(self.start)
        s, e = self.start[order], self.start[order] + self.dur[order]
        if clip:
            s, e = np.clip(s, self.t0, self.t1), np.clip(e, self.t0, self.t1)
        merged = []
        cur_s, cur_e = s[0], e[0]
        for a, b in zip(s[1:], e[1:]):
            if a <= cur_e:
                cur_e = max(cur_e, b)
            else:
                merged.append((cur_s, cur_e))
                cur_s, cur_e = a, b
        merged.append((cur_s, cur_e))
        return np.asarray(merged)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0

    def gaps(self) -> np.ndarray:
        """(k, 2) idle intervals of the window."""
        iv = self.busy_intervals(clip=True)
        edges = np.concatenate([[self.t0], iv.reshape(-1), [self.t1]])
        g = edges.reshape(-1, 2)
        return g[g[:, 1] > g[:, 0]]

    def ops(self, substring: str) -> tuple[np.ndarray, np.ndarray]:
        """Start times and durations of the operations whose name holds
        ``substring``, in time order."""
        idx = np.array([i for i, n in enumerate(self.names)
                        if substring in n], dtype=np.int64)
        if not idx.size:
            return np.empty(0), np.empty(0)
        order = idx[np.argsort(self.start[idx])]
        return self.start[order], self.dur[order]

    def kernel_s(self) -> float:
        """Device seconds of the kernels alone: no copy, no memset."""
        if self.cats is None:
            return 0.0
        return float(sum(d for c, d in zip(self.cats, self.dur)
                         if c == "kernel"))

    def time_by_name(self) -> list[tuple[str, float]]:
        """Device seconds summed by operation name, largest first."""
        total: dict[str, float] = {}
        for n, d in zip(self.names, self.dur):
            total[n] = total.get(n, 0.0) + float(d)
        return sorted(total.items(), key=lambda kv: -kv[1])


class Tracer:
    """Profiles the device from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._t0 = self._offset = 0.0

    @staticmethod
    def can_trace(device: str) -> bool:
        """Whether a run on ``device`` has a device to trace: a run on
        the CPU has none."""
        return device != "cpu"

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._offset = time.time() - time.perf_counter()
        self._t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        import torch

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            os.remove(path)
        self._prof = None
        return parse(doc, self._offset, self._t0, t1)


def parse(doc: dict, offset: float, t0: float, t1: float) -> DeviceTrace:
    """The device operations of a chrome trace ``doc``; ``offset`` is the
    wall clock less the perf_counter clock."""
    base_ns = float(doc.get("baseTimeNanoseconds", 0))
    names, cats, start, dur = [], [], [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        names.append(ev["name"])
        cats.append(ev["cat"])
        start.append((base_ns + float(ev["ts"]) * 1e3) / 1e9 - offset)
        dur.append(float(ev.get("dur", 0.0)) / 1e6)
    return DeviceTrace(names, np.asarray(start, dtype=np.float64),
                       np.asarray(dur, dtype=np.float64), t0, t1, cats)
