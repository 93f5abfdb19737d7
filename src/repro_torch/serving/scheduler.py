"""Continuous micro-batching scheduler: batch formation + queue policy.

This module is the pure policy half of the serving stack — it never touches
an engine. The :class:`~repro_torch.serving.api.Server` pushes admitted
requests in and pops formed micro-batches out; everything in between is
deterministic given a clock:

  * **per-stream queues** — one priority queue per engine stream key (the
    GNN engine streams by (model, graph)). Within a stream, entries pop by
    descending ``priority``, then earliest absolute deadline (EDF), then
    arrival order — so equal-priority no-deadline traffic is strictly
    FIFO.
  * **hybrid formation policy** — a stream is dispatchable when it holds
    ``max_batch_size`` entries OR its oldest entry has waited
    ``max_wait_ms`` (0 means "form as soon as anything is queued"). The
    caller can ``force`` formation to flush underfull streams.
  * **bounded admission** — ``push`` refuses entries once a stream is
    ``max_queue_depth`` deep; the server surfaces that as a typed
    ``Rejected`` outcome (backpressure) instead of letting queues grow.
  * **starvation guard** — stream selection normally follows the best head
    entry (priority, then deadline, then arrival), which can starve a
    low-priority stream under sustained high-priority load; any stream
    whose head has waited ``starvation_ms`` preempts that ordering,
    oldest head first.
  * **expiry sweep** — entries whose deadline passed while queued are
    swept out and handed back so the server resolves them as ``Expired``
    rather than silently dropping (or worse, serving) them.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Any, Hashable


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Batch-formation and admission policy knobs.

    max_batch_size: micro-batch cap per dispatch.
    max_wait_ms: oldest-entry wait that makes an underfull stream
        dispatchable (0 = dispatch as soon as anything is queued).
    max_queue_depth: per-stream admission bound; pushes beyond it are
        refused (backpressure).
    starvation_ms: head wait beyond which a stream preempts the normal
        priority ordering.
    """

    max_batch_size: int = 8
    max_wait_ms: float = 0.0
    max_queue_depth: int = 256
    starvation_ms: float = 1000.0


@dataclasses.dataclass
class QueueEntry:
    """One queued request plus the bookkeeping the server resolves with."""

    payload: Any
    ticket: Any                     # resolved by the Server, opaque here
    priority: int = 0
    arrival_s: float = 0.0
    deadline_s: float | None = None  # absolute, on the server's clock
    seq: int = -1                    # admission order, assigned by push

    def sort_key(self) -> tuple:
        # higher priority first, then earliest deadline, then admission
        # order; seq is unique so heap tuples never compare entries
        dl = math.inf if self.deadline_s is None else self.deadline_s
        return (-self.priority, dl, self.seq)


class MicroBatchScheduler:
    """Per-stream priority queues + the hybrid formation policy."""

    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        self._queues: dict[Hashable, list[tuple[tuple, QueueEntry]]] = {}
        # per-stream oldest arrival, maintained incrementally: push takes a
        # min, removals (dispatch / expiry) recompute once over what's
        # left. next_batch() reads it O(streams) instead of re-scanning
        # every queued entry (O(depth) per stream) on every tick.
        self._oldest: dict[Hashable, float] = {}
        self._seq = itertools.count()
        self._queued_deadlines = 0     # lets deadline-free sweeps short-circuit
        # the scheduler is pure policy with NO lock of its own: every
        # entry point (push / sweep_expired / next_batch / depth) is
        # called by the Server under its queue lock — the annotation
        # documents that external invariant for the concurrency pass
        self.stats = {"admitted": 0, "rejected": 0, "expired": 0,  # guarded-by: Server._cv
                      "dispatched": 0, "batches": 0, "peak_depth": 0}

    def depth(self, key: Hashable | None = None) -> int:
        if key is not None:
            return len(self._queues.get(key, ()))
        return sum(len(q) for q in self._queues.values())

    def streams(self) -> list[Hashable]:
        return [k for k, q in self._queues.items() if q]

    # -- admission ---------------------------------------------------------

    def push(self, key: Hashable, entry: QueueEntry) -> bool:
        """Admit ``entry`` to stream ``key``; False = stream full."""
        q = self._queues.setdefault(key, [])
        if len(q) >= self.config.max_queue_depth:
            self.stats["rejected"] += 1
            return False
        entry.seq = next(self._seq)
        heapq.heappush(q, (entry.sort_key(), entry))
        cur = self._oldest.get(key)
        self._oldest[key] = entry.arrival_s if cur is None \
            else min(cur, entry.arrival_s)
        if entry.deadline_s is not None:
            self._queued_deadlines += 1
        self.stats["admitted"] += 1
        self.stats["peak_depth"] = max(self.stats["peak_depth"], self.depth())
        return True

    # -- expiry ------------------------------------------------------------

    def sweep_expired(self, now: float) -> list[QueueEntry]:
        """Remove and return every queued entry whose deadline has passed
        (the server resolves them as Expired — they must not vanish)."""
        if not self._queued_deadlines:  # deadline-free traffic: no rebuild
            return []
        expired: list[QueueEntry] = []
        for key in list(self._queues):
            q = self._queues[key]
            live = [(k, e) for k, e in q
                    if e.deadline_s is None or e.deadline_s > now]
            if len(live) != len(q):
                expired.extend(e for k, e in q
                               if e.deadline_s is not None
                               and e.deadline_s <= now)
                heapq.heapify(live)
                if live:
                    self._queues[key] = live
                    self._oldest[key] = min(e.arrival_s for _, e in live)
                else:
                    del self._queues[key]
                    self._oldest.pop(key, None)
        self._queued_deadlines -= len(expired)
        self.stats["expired"] += len(expired)
        return expired

    # -- formation ---------------------------------------------------------

    def _head_wait_ms(self, key: Hashable, now: float) -> float:
        return (now - self._oldest[key]) * 1e3

    def next_batch(self, now: float, *, force: bool = False
                   ) -> tuple[Hashable, list[QueueEntry]] | None:
        """Form one micro-batch, or None when no stream is dispatchable.

        ``force`` flushes underfull streams regardless of ``max_wait_ms``
        (drain semantics).
        """
        cfg = self.config
        waits = {key: self._head_wait_ms(key, now)  # O(1) per stream
                 for key, q in self._queues.items() if q}
        ready = [key for key, q in self._queues.items() if q
                 and (force or len(q) >= cfg.max_batch_size
                      or waits[key] >= cfg.max_wait_ms)]
        if not ready:
            return None
        starving = [k for k in ready if waits[k] >= cfg.starvation_ms]
        if starving:
            key = max(starving, key=waits.__getitem__)
        else:
            key = min(ready, key=lambda k: self._queues[k][0][0])
        q = self._queues[key]
        batch = [heapq.heappop(q)[1]
                 for _ in range(min(cfg.max_batch_size, len(q)))]
        if not q:
            del self._queues[key]
            del self._oldest[key]
        else:
            self._oldest[key] = min(e.arrival_s for _, e in q)
        self._queued_deadlines -= sum(e.deadline_s is not None
                                      for e in batch)
        self.stats["batches"] += 1
        self.stats["dispatched"] += len(batch)
        return key, batch
