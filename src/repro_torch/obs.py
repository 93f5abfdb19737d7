"""Spans on the program's host path, on the clock a device trace can be
moved onto.

    from repro_torch import obs

    obs.enable()
    with obs.span("runtime.softmax"):
        ...
    records, dropped = obs.drain()
    obs.disable()

A record is ``(name, thread, t0, t1)``: the span's name, the name of the
thread that opened it, and its start and end on ``time.perf_counter``.
That is the clock a ``torch.profiler`` trace of the device is moved onto
(by the offset between it and the wall clock), so the program's host
steps and its kernels line up. Each name begins with its layer:
``server.``, ``engine.``, ``runtime.``, ``python.``.

Off, the default, :func:`span` tests one module flag and returns a shared
object that does nothing: no allocation and no clock read. On, a span
appends its record when it closes. A span may be opened on one thread and
closed on another (``server.queue``: opened at admission in
``Server.submit``, closed at dispatch on the server thread), and
``end()`` stamps its end ahead of ``close()``, for a span recorded only
if what follows it happens (``server.lock_wait`` of a step pass that
dispatches a batch). A span still open when the recorder is switched off
records nothing.

Records go into a deque that holds at most :data:`CAPACITY` undrained
records; past that, new records are kept out and counted, and
:func:`drain` reports the count, so a recorder left on holds bounded
memory. While on, each collection of Python's garbage collector is
recorded as ``python.gc.gen<generation>`` on the thread that triggered
it.

Spans are appended from any thread (``deque.append`` and ``next`` on a
counter are atomic under the interpreter lock); :func:`enable` and
:func:`disable` are called from one controlling thread.
"""
from __future__ import annotations

import collections
import gc
import itertools
import threading
import time

# undrained records kept; ~120 bytes each
CAPACITY = 1 << 19

_on = False
_records: collections.deque = collections.deque()
_dropped = itertools.count()     # next() is atomic under the GIL
_gc_t0 = 0.0                     # collections never overlap


class _Off:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def end(self) -> None:
        pass

    def close(self) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "thread", "t0", "t1")

    def __init__(self, name: str):
        self.name = name
        self.thread = threading.current_thread().name
        self.t1 = None
        self.t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def end(self) -> None:
        """Stamp the end now; :meth:`close` records the span later."""
        if self.t1 is None:
            self.t1 = time.perf_counter()

    def close(self) -> None:
        t1 = time.perf_counter() if self.t1 is None else self.t1
        _keep((self.name, self.thread, self.t0, t1))


def _keep(record: tuple) -> None:
    if not _on:
        return
    if len(_records) < CAPACITY:
        _records.append(record)
    else:
        next(_dropped)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter()
    else:
        _keep((f"python.gc.gen{info['generation']}",
               threading.current_thread().name, _gc_t0,
               time.perf_counter()))


def span(name: str):
    """A context manager that records ``name`` from its opening to its
    closing while the recorder is on; a shared no-op object while off."""
    if not _on:
        return _OFF
    return _Span(name)


def enable() -> None:
    """Start recording spans and garbage collections."""
    global _on
    if not _on:
        gc.callbacks.append(_on_gc)
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`drain`."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)


def enabled() -> bool:
    return _on


def drain() -> tuple[list[tuple], int]:
    """``(records, dropped)``: the records kept since the last drain, in
    the order they closed, and how many were kept out for want of room;
    clears both."""
    global _dropped
    out = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            break
    dropped, _dropped = _dropped, itertools.count()
    return out, next(dropped)
