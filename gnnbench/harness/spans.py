"""The program's own spans in a traced run, and the reductions the
per-layer metrics and the breakdown read of them.

The program records spans with ``repro_torch.obs`` (each
``(name, thread, t0, t1)`` on the ``time.perf_counter`` clock the device
trace is moved onto). The driver switches the recorder on just before
the profiler starts in every ``--trace 1`` run and, once the profiler has
stopped, switches it off and keeps what it recorded in ``run.spans`` (a
:class:`Spans`), whatever readers the cell lists. A ``--trace 0`` run
never switches it on. Where the program has no recorder, ``run.spans``
stays None, the readers here return None and the breakdown names idle
gaps by the closed loop's records alone.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np


@dataclasses.dataclass
class Spans:
    """What the program recorded over a traced window."""

    records: list           # (name, thread, t0, t1), perf_counter clock
    dropped: int            # records kept out for want of room

    @functools.cached_property
    def pieces(self) -> tuple:
        """The records' self intervals, ``(labels, idx, lo, hi)``: piece
        ``i`` spans ``[lo[i], hi[i]]`` of the span ``labels[idx[i]]``, a
        ``(thread, name)``."""
        pieces = self_intervals(self.records)
        labels: dict = {}
        idx = [labels.setdefault((th, name), len(labels))
               for name, th, _, _ in pieces]
        return (list(labels), np.asarray(idx, dtype=np.int64),
                np.asarray([p[2] for p in pieces], dtype=np.float64),
                np.asarray([p[3] for p in pieces], dtype=np.float64))


def self_intervals(records) -> list[tuple]:
    """``(name, thread, lo, hi)`` pieces: each instant of a thread's spans
    belongs to the innermost span open then on that thread (the one
    opened last), so a span's pieces are its interval less its
    children's."""
    by_thread = collections.defaultdict(list)
    for rec in records:
        by_thread[rec[1]].append(rec)
    out = []
    for thread, group in by_thread.items():
        events = []
        for k, (_, _, t0, t1) in enumerate(group):
            events.append((t0, 1, -t1, k))   # the outer of two starts first
            events.append((t1, 0, 0.0, k))   # ends before starts
        events.sort()
        open_, prev, last = [], 0.0, None
        for t, starts, _, k in events:
            if open_ and t > prev:
                top = open_[-1]
                if top == last and out[-1][3] == prev:      # one piece
                    out[-1] = out[-1][:3] + (t,)
                else:
                    out.append((group[top][0], thread, prev, t))
                last = top
            prev = t
            if starts:
                open_.append(k)
            else:
                open_.remove(k)
    return out


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


# -- reductions ---------------------------------------------------------------

def window(run) -> list[tuple] | None:
    """The run's records clipped to its window; None where the program
    recorded none or some were dropped."""
    sp = run.spans
    if sp is None or sp.dropped:
        return None
    a, b = run.t_open, run.t_close
    return [(name, th, max(t0, a), min(t1, b))
            for name, th, t0, t1 in sp.records if t1 > a and t0 < b]


def _named(name: str, names) -> bool:
    return any(name == n or name.startswith(n + ".") for n in names)


def per_refresh_ms(run, *names: str) -> float | None:
    """Σ of the window's spans named ``names`` (or ``<name>.<suffix>``)
    over the refreshes completed in it, in ms."""
    got = window(run)
    done = sum(r.outcome == "completed" for r in run.refreshes)
    if got is None or not done:
        return None
    total = sum(t1 - t0 for name, _, t0, t1 in got if _named(name, names))
    return total / done * 1e3


def self_ms(run) -> dict | None:
    """``{(thread, name): ms}``: each span's self time in the window over
    the refreshes completed in it."""
    got = window(run)
    done = sum(r.outcome == "completed" for r in run.refreshes)
    if got is None or not done:
        return None
    out: dict = collections.defaultdict(float)
    for name, th, lo, hi in self_intervals(got):
        out[(th, name)] += (hi - lo) / done * 1e3
    return dict(out)


def _union(intervals) -> list[tuple]:
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def untraced_idle(run) -> float | None:
    """% of the window's device-idle time that no program span covers."""
    got = window(run)
    if got is None:
        return None
    gaps = run.trace.gaps()
    idle = float((gaps[:, 1] - gaps[:, 0]).sum())
    if idle <= 0:
        return None
    covered, busy = 0.0, _union((t0, t1) for _, _, t0, t1 in got)
    j = 0
    for a, b in gaps:           # both sorted, each disjoint
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return 100.0 * (idle - covered) / idle


def gap_name(run, a: float, b: float) -> str | None:
    """``program <thread>: <span>`` for the span whose self time covers
    most of [a, b], None where no program span covers any of it."""
    sp = run.spans
    if sp is None:
        return None
    labels, idx, lo, hi = sp.pieces
    if not idx.size:
        return None
    over = np.clip(np.minimum(hi, b) - np.maximum(lo, a), 0.0, None)
    cover = np.bincount(idx, weights=over, minlength=len(labels))
    best = int(cover.argmax())
    if cover[best] <= 0:
        return None
    thread, name = labels[best]
    return f"program {thread}: {name}"
