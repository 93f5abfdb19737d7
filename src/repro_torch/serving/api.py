"""Transport-agnostic async serving core: Server, Ticket, typed outcomes.

One request lifecycle for every engine:

    server = Server(engine, SchedulerConfig(max_batch_size=8))
    ticket = server.submit(request, priority=1, deadline_ms=50.0)
    ...
    server.drain()                       # or server.start() a background thread
    outcome = ticket.result()            # Completed | Rejected | Expired | Failed
    if isinstance(outcome, Completed):
        use(outcome.value)               # queue_ms / engine_ms attached

Any engine that implements the two-method step protocol plugs in
(:class:`repro_torch.serving.gnn_engine.GNNServeEngine` is one):

    class Engine(Protocol):
        def route(self, payload) -> Hashable:
            '''Validate one request and name the stream that batches it
            (GNN: the (model, graph) pair). Raise to reject.'''
        def step(self, key, payloads: Sequence) -> Sequence:
            '''Run one formed micro-batch; results match payloads
            positionally. An Exception instance in the result list fails
            that request alone (typed Failed); raising fails the whole
            batch.'''

Batch formation, priority/EDF ordering, bounded admission and the
starvation guard live in :mod:`repro_torch.serving.scheduler`; this
module owns the request lifecycle (tickets, outcomes, metrics) and the two
drive modes — cooperative (``step()``/``drain()``/``Ticket.result()`` drive the
scheduler inline) and threaded (``start()`` runs a background thread so
``submit`` is truly asynchronous). Engine steps run outside the queue
lock, so submissions never block behind compute.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Hashable, Protocol, Sequence, runtime_checkable

from repro_torch.analyze.lock_sanitizer import new_condition, new_lock
from repro_torch.serving.scheduler import (MicroBatchScheduler,
                                           QueueEntry, SchedulerConfig)


@runtime_checkable
class Engine(Protocol):
    """The step protocol the scheduler drives (see module docstring)."""

    def route(self, payload) -> Hashable: ...

    def step(self, key, payloads: Sequence) -> Sequence: ...


# -- typed outcomes --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Completed:
    """The engine answered: ``value`` is its result for this request."""

    value: Any
    queue_ms: float = 0.0       # admission -> batch dispatch
    engine_ms: float = 0.0      # this request's share of engine time

    @property
    def latency_ms(self) -> float:
        return self.queue_ms + self.engine_ms


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Refused at admission: invalid request or queue-full backpressure.

    ``kind`` is the machine-readable discriminator ("invalid" — the
    engine's route() raised — or "backpressure" — the stream queue is
    full, retrying after the server drains can succeed); ``reason`` is
    prose for humans.
    """

    reason: str
    kind: str = "invalid"


@dataclasses.dataclass(frozen=True)
class Expired:
    """The deadline passed while queued; the engine never ran it."""

    deadline_ms: float
    waited_ms: float


@dataclasses.dataclass(frozen=True)
class Failed:
    """The engine raised while running this request's micro-batch."""

    error: str


Outcome = Completed | Rejected | Expired | Failed


class Ticket:
    """Handle for one submitted request: ``poll()`` / ``result()``."""

    def __init__(self, server: "Server", ticket_id: int, priority: int,
                 deadline_ms: float | None, arrival_s: float):
        self.id = ticket_id
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.arrival_s = arrival_s
        self._server = server
        self._event = threading.Event()
        self._outcome: Outcome | None = None

    def poll(self) -> Outcome | None:
        """Non-blocking: the outcome, or None while still queued/running."""
        return self._outcome

    @property
    def done(self) -> bool:
        return self._outcome is not None

    def result(self, timeout_s: float | None = None) -> Outcome:
        """Block until resolved. Cooperative mode drives the server's
        scheduler inline; with a background thread running it just waits."""
        outcome = self._server._wait(self, timeout_s)
        if outcome is None:
            raise TimeoutError(f"ticket {self.id} unresolved after "
                               f"{timeout_s}s")
        return outcome

    def _resolve(self, outcome: Outcome) -> None:
        if self._outcome is not None:  # exactly-once is a core invariant
            raise RuntimeError(f"ticket {self.id} resolved twice")
        self._outcome = outcome
        self._event.set()


class Server:
    """Continuous-batching server over any :class:`Engine`."""

    def __init__(self, engine: Engine, config: SchedulerConfig | None = None,
                 *, clock=time.monotonic):
        self._engine = engine
        self._sched = MicroBatchScheduler(config)
        self._clock = clock
        # the queue lock: guards the scheduler, the metrics dict and
        # ticket resolution. Built through the lock_sanitizer factory so
        # REPRO_LOCKSAN runs get acquisition-order checking (a plain
        # threading.Condition otherwise)
        self._cv = new_condition("Server._cv")
        # serializes whole step() passes: engines are not required to be
        # thread-safe, so a background thread and an inline step()/drain()
        # caller must never run engine.step concurrently. Lock order is
        # always _step_lock -> _cv (step() -> _step()), never reversed.
        self._step_lock = new_lock("Server._step_lock")
        # background-thread lifecycle: written only by the caller thread that
        # owns start()/stop() (single-writer by contract)
        self._thread: threading.Thread | None = None  # guarded-by: caller
        self._stopping = False                        # guarded-by: caller
        self._ids = itertools.count()   # next() is atomic under the GIL
        self._m = {"submitted": 0, "rejected": 0, "completed": 0,  # guarded-by: _cv
                   "failed": 0, "reloads": 0, "mutations": 0,
                   "queue_ms_total": 0.0, "engine_ms_total": 0.0}

    @property
    def config(self) -> SchedulerConfig:
        return self._sched.config

    # -- request lifecycle -------------------------------------------------

    def submit(self, payload, *, priority: int = 0,
               deadline_ms: float | None = None) -> Ticket:
        """Admit one request; never raises for load or bad requests —
        the returned ticket resolves to a typed ``Rejected`` instead."""
        now = self._clock()
        ticket = Ticket(self, next(self._ids), priority, deadline_ms, now)
        with self._cv:
            self._m["submitted"] += 1
            try:
                key = self._engine.route(payload)
            except Exception as err:
                self._m["rejected"] += 1
                ticket._resolve(Rejected(f"{type(err).__name__}: {err}",
                                         kind="invalid"))
                return ticket
            entry = QueueEntry(
                payload=payload, ticket=ticket, priority=priority,
                arrival_s=now,
                deadline_s=None if deadline_ms is None
                else now + deadline_ms / 1e3)
            if not self._sched.push(key, entry):
                self._m["rejected"] += 1
                ticket._resolve(Rejected(
                    f"stream {key!r} at max queue depth "
                    f"{self._sched.config.max_queue_depth} (backpressure)",
                    kind="backpressure"))
                return ticket
            self._cv.notify_all()
        return ticket

    def step(self, *, force: bool = False) -> int:
        """Sweep expired entries, form one micro-batch and run it through
        the engine. Returns the number of tickets resolved (completed +
        expired + failed); 0 means nothing was dispatchable. Safe to call
        while a background thread runs: step passes are serialized."""
        with self._step_lock:
            return self._step(force)

    def _step(self, force: bool) -> int:
        with self._cv:
            now = self._clock()
            expired = self._sched.sweep_expired(now)
            for e in expired:
                e.ticket._resolve(Expired(
                    deadline_ms=e.ticket.deadline_ms,
                    waited_ms=(now - e.arrival_s) * 1e3))
            formed = self._sched.next_batch(now, force=force)
            if formed is None:
                return len(expired)
            key, entries = formed
            dispatch_s = now
        payloads = [e.payload for e in entries]
        t0 = time.perf_counter()
        try:
            results = list(self._engine.step(key, payloads))
            if len(results) != len(entries):
                raise RuntimeError(
                    f"engine step returned {len(results)} results for "
                    f"{len(entries)} payloads on stream {key!r}")
        except Exception as err:
            with self._cv:
                self._m["failed"] += len(entries)
                for e in entries:
                    e.ticket._resolve(Failed(f"{type(err).__name__}: {err}"))
            return len(expired) + len(entries)
        batch_ms = (time.perf_counter() - t0) * 1e3
        with self._cv:
            for e, r in zip(entries, results):
                if isinstance(r, Exception):
                    # engines may fail a single request positionally (e.g.
                    # a stale node id) without poisoning its co-batch
                    self._m["failed"] += 1
                    e.ticket._resolve(Failed(f"{type(r).__name__}: {r}"))
                    continue
                queue_ms = (dispatch_s - e.arrival_s) * 1e3
                # engines that time each request (GNN Predictions) report
                # per-request engine_ms; otherwise charge the batch wall
                engine_ms = getattr(r, "engine_ms", None)
                engine_ms = batch_ms if engine_ms is None else engine_ms
                if hasattr(r, "queue_ms"):
                    r.queue_ms = queue_ms
                    if hasattr(r, "latency_ms"):
                        r.latency_ms = queue_ms + engine_ms
                e.ticket._resolve(Completed(
                    value=r, queue_ms=queue_ms, engine_ms=engine_ms))
                self._m["completed"] += 1
                self._m["queue_ms_total"] += queue_ms
                self._m["engine_ms_total"] += engine_ms
        return len(expired) + len(entries)

    def drain(self) -> int:
        """Run until every queue is empty (flushes underfull batches);
        returns the number of tickets resolved."""
        total = 0
        while True:
            n = self.step(force=True)
            total += n
            if n == 0:
                return total

    def queue_depth(self, key: Hashable | None = None) -> int:
        with self._cv:
            return self._sched.depth(key)

    def reload(self, apply_fn):
        """Hot engine update (e.g. a weight reload) serialized with engine
        steps: ``apply_fn(engine)`` runs under the step lock, so a
        micro-batch that is already inside the engine finishes on the old
        state, and every batch dispatched after the reload sees the new
        state — queued (in-flight) tickets are never Failed by the swap.

            server.reload(lambda eng: eng.reload_params("gcn", params))

        Returns ``apply_fn``'s result. Exceptions propagate to the caller
        (the engine was not modified on a validation error) and do not
        touch queued requests.
        """
        with self._step_lock:
            out = apply_fn(self._engine)
        with self._cv:
            self._m["reloads"] += 1
        return out

    def mutate(self, graph: str, delta):
        """Apply a :class:`~repro_torch.graphs.delta.GraphDelta` to a
        served graph, serialized with engine steps exactly like
        :meth:`reload`: the mutation runs under the step lock, so a
        micro-batch already inside the engine finishes on the pre-delta
        snapshot and every batch dispatched afterwards sees the
        post-delta graph — queued tickets are never Failed by the swap.

        Requires an engine with a ``mutate`` method (the GNN engine).
        Returns the engine's mutation report. Exceptions propagate (an
        invalid delta leaves the engine untouched) and do not touch
        queued requests.
        """
        mutate_fn = getattr(self._engine, "mutate", None)
        if mutate_fn is None:
            raise TypeError(
                f"engine {type(self._engine).__name__} does not support "
                f"graph mutation (no .mutate)")
        with self._step_lock:
            out = mutate_fn(graph, delta)
        with self._cv:
            self._m["mutations"] += 1
        return out

    @property
    def engine(self):
        """The wrapped engine. Mutating engine state directly bypasses
        step serialization — use :meth:`reload` / :meth:`mutate` for
        anything that changes what queued requests will observe."""
        return self._engine

    # -- background thread (optional) --------------------------------------

    def start(self, poll_interval_s: float = 0.002, *,
              analyze: str | None = None) -> "Server":
        """Run a daemon thread that steps the server, so ``submit`` is
        fire-and-forget.

        ``analyze`` runs the static-analysis preflight
        (:func:`repro_torch.analyze.preflight` — the host-sync and
        lock-discipline lints over the deployed hot paths plus every
        pass on each already-compiled Executable) before the thread
        starts: ``"warn"`` issues a ``UserWarning`` for warning-or-worse
        findings, ``"error"`` refuses to start (raises
        :class:`repro_torch.analyze.AnalysisError`) on any error finding
        — a misconfigured engine should fail at startup, not stall the
        queue at peak. The preflight holds the step lock, so on a server
        already started it runs between two steps.
        """
        if analyze not in (None, "off", "warn", "error"):
            raise ValueError(f"analyze must be None, 'off', 'warn' or "
                             f"'error', got {analyze!r}")
        if analyze in ("warn", "error"):
            from repro_torch import analyze as _analyze
            # The preflight's passes run real forwards over the engine's
            # executables: hold the step lock so a running driver's
            # step, a reload or a mutate cannot run beside them.
            with self._step_lock:
                report = _analyze.preflight(self._engine)
            if analyze == "error" and report.failed("error"):
                raise _analyze.AnalysisError(report)
            if report.at_least("warning"):
                import warnings
                warnings.warn(f"serving preflight analysis:\n"
                              f"{report.render()}", stacklevel=2)
        if self._thread is None:
            self._stopping = False
            self._thread = threading.Thread(
                target=self._drive, args=(poll_interval_s,), daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the background thread (then flush what's left inline)."""
        if self._thread is not None:
            self._stopping = True
            with self._cv:
                self._cv.notify_all()
            self._thread.join()
            self._thread = None
        if drain:
            self.drain()

    def _drive(self, poll_interval_s: float) -> None:
        while not self._stopping:
            if self.step() == 0:
                with self._cv:
                    if self._stopping:
                        return
                    # short poll while work is queued but not yet
                    # dispatchable (max_wait window), long poll when idle
                    self._cv.wait(poll_interval_s if self._sched.depth()
                                  else 0.05)

    def _wait(self, ticket: Ticket, timeout_s: float | None) -> Outcome | None:
        if self._thread is not None:
            ticket._event.wait(timeout_s)
            return ticket._outcome
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while ticket._outcome is None:
            if deadline is not None and time.monotonic() > deadline:
                return None
            # cooperative: result() steps the scheduler; fall back to a forced
            # (flush) step so an underfull max_wait batch can't spin forever
            if self.step() == 0 and self.step(force=True) == 0 \
                    and ticket._outcome is None:
                raise RuntimeError(
                    f"server idle but ticket {ticket.id} unresolved")
        return ticket._outcome

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        """Queue/admission/latency counters (queue_ms/engine_ms are summed
        over completed requests; divide by ``completed`` for means)."""
        with self._cv:
            s = self._sched.stats
            return {**self._m,
                    "admitted": s["admitted"],
                    "expired": s["expired"],
                    "batches": s["batches"],
                    "dispatched": s["dispatched"],
                    "queue_depth": self._sched.depth(),
                    "peak_queue_depth": s["peak_depth"]}

    def report(self) -> str:
        m = self.metrics()
        mean_b = m["dispatched"] / m["batches"] if m["batches"] else 0.0
        mean_q = m["queue_ms_total"] / m["completed"] if m["completed"] else 0.0
        mean_e = m["engine_ms_total"] / m["completed"] if m["completed"] else 0.0
        return (f"server: {m['completed']}/{m['submitted']} completed, "
                f"{m['rejected']} rejected, {m['expired']} expired | "
                f"{m['batches']} batches (mean size {mean_b:.1f}, "
                f"peak queue depth {m['peak_queue_depth']}) | "
                f"mean queue {mean_q:.2f} ms, mean engine {mean_e:.2f} ms")
