"""Dynamic lock-order sanitizer: runtime half of the concurrency pass.

A copy of the reference's ``repro.analyze.lock_sanitizer``. The static
pass (:mod:`repro_torch.analyze.concurrency`) reasons about locks it
can see lexically; this module watches the locks the process *actually*
takes. It is an opt-in (``REPRO_LOCKSAN=1``) instrumented wrapper over
``threading.Lock`` / ``RLock`` / ``Condition`` that records per-thread
acquisition stacks and checks two properties while tests hammer the
serving stack:

  * **LS001** (error)   — a globally consistent lock order. Every time a
    thread acquires lock B while holding lock A, the sanitizer records
    the edge A→B (with the two acquisition sites as the witness). A
    cycle in that graph means two threads can take the same locks in
    opposite orders — the classic deadlock — and is reported with the
    full witness path the moment the closing edge appears, without the
    test having to actually interleave into the deadlock.
  * **LS002** (warning) — held-lock duration. Releasing a lock after
    holding it longer than ``hold_ms`` (default 100 ms, env
    ``REPRO_LOCKSAN_HOLD_MS``) flags blocking work under a lock — the
    serving-stall hazard CL003 looks for statically. ``Condition.wait``
    windows do not count: the wrapper implements ``_release_save`` /
    ``_acquire_restore``, so the hold clock stops while the lock is
    released for the wait.

Instrumentation is by construction, not monkey-patching: the serving
stack creates its locks through :func:`new_lock` / :func:`new_rlock` /
:func:`new_condition`, which return plain ``threading`` primitives when
the sanitizer is off (zero overhead in production) and named
:class:`_SanLock` wrappers when it is on. Tests force it on for a scope
with :func:`sanitize`, independent of the environment::

    with lock_sanitizer.sanitize(hold_ms=250) as san:
        server = Server(engine).start()
        ...
        san.assert_clean()          # raises AnalysisError on LS001

Violations are :class:`~repro_torch.analyze.report.Finding`s under the
``lock-order`` pass, so they feed the same Report/CI machinery as every
static pass.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from repro_torch.analyze.report import AnalysisError, Finding, Report

PASS = "lock-order"

ENV = "REPRO_LOCKSAN"
ENV_HOLD_MS = "REPRO_LOCKSAN_HOLD_MS"
DEFAULT_HOLD_MS = 100.0

_THIS_FILE = __file__
_THREADING_FILE = threading.__file__


def enabled() -> bool:
    """True when the ``REPRO_LOCKSAN`` environment opt-in is set."""
    return os.environ.get(ENV, "").strip().lower() not in \
        ("", "0", "false", "off")


def _call_site() -> str:
    """First stack frame outside this module and ``threading``."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn not in (_THIS_FILE, _THREADING_FILE):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class LockSanitizer:
    """Acquisition-order + hold-duration checker shared by all wrapped
    locks. Thread-safe: its own state is guarded by one raw ``Lock``
    (never a wrapped one, so the sanitizer cannot observe itself)."""

    def __init__(self, *, hold_ms: float | None = None):
        if hold_ms is None:
            hold_ms = float(os.environ.get(ENV_HOLD_MS, DEFAULT_HOLD_MS))
        self.hold_ms = hold_ms
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (a, b): thread held a while acquiring b -> witness sites
        self._edges: dict[tuple[str, str], str] = {}
        self._findings: list[Finding] = []
        self._cycles_seen: set[frozenset] = set()
        self._holds_seen: set[tuple[str, str]] = set()
        self.acquisitions = 0

    # -- per-thread held stack ---------------------------------------------

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def _on_acquire(self, name: str, site: str) -> None:
        held = self._held()
        for prev_name, _s, _t in held:
            if prev_name != name:
                self._record_edge(
                    prev_name, name,
                    f"held since {_s}, acquiring at {site} "
                    f"[{threading.current_thread().name}]")
        held.append((name, site, time.perf_counter()))
        with self._mu:
            self.acquisitions += 1

    def _on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _n, site, t0 = held.pop(i)
                dur_ms = (time.perf_counter() - t0) * 1e3
                if dur_ms > self.hold_ms:
                    self._record_long_hold(name, site, dur_ms)
                return
        # release without a tracked acquire (e.g. lock taken before the
        # sanitizer attached) — nothing to check

    # -- edge graph ----------------------------------------------------------

    def _record_edge(self, a: str, b: str, witness: str) -> None:
        with self._mu:
            if (a, b) in self._edges:
                return
            self._edges[(a, b)] = witness
            path = self._find_path(b, a)
            if path is None:
                return
            cycle = [a] + path            # a -> b -> ... -> a
            nodes = frozenset(cycle)
            if nodes in self._cycles_seen:
                return
            self._cycles_seen.add(nodes)
            steps = "; ".join(
                f"{x} -> {y} ({self._edges[(x, y)]})"
                for x, y in zip(cycle, cycle[1:]))
            self._findings.append(Finding(
                rule="LS001", severity="error", pass_name=PASS,
                message=f"inconsistent lock acquisition order (deadlock "
                        f"hazard): {steps}",
                location=a))

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """[src, ..., dst] over recorded edges, or None. Caller holds
        ``_mu``."""
        adj: dict[str, list[str]] = {}
        for (x, y) in self._edges:
            adj.setdefault(x, []).append(y)
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _record_long_hold(self, name: str, site: str, dur_ms: float) -> None:
        with self._mu:
            if (name, site) in self._holds_seen:
                return
            self._holds_seen.add((name, site))
            self._findings.append(Finding(
                rule="LS002", severity="warning", pass_name=PASS,
                message=f"{name} held for {dur_ms:.0f} ms (threshold "
                        f"{self.hold_ms:.0f} ms); blocking work under a "
                        f"lock stalls every thread waiting on it",
                location=f"{name} acquired at {site}"))

    # -- results -------------------------------------------------------------

    def findings(self) -> list[Finding]:
        with self._mu:
            return list(self._findings)

    def report(self) -> Report:
        rep = Report()
        rep.extend(self.findings())
        return rep

    def assert_clean(self, fail_on: str = "error") -> None:
        rep = self.report()
        if rep.failed(fail_on):
            raise AnalysisError(rep)


class _SanLock:
    """Named wrapper over one ``threading.Lock``/``RLock`` reporting to a
    :class:`LockSanitizer`. Implements the private Condition protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) so a real
    ``threading.Condition`` can run on top of it — with hold timing
    suspended across ``wait()``."""

    def __init__(self, inner, name: str, san: LockSanitizer):
        self._inner = inner
        self.name = name
        self._san = san

    def __repr__(self):
        return f"<SanLock {self.name} over {self._inner!r}>"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._on_acquire(self.name, _call_site())
        return got

    def release(self) -> None:
        self._san._on_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        return fn() if fn is not None else self._is_owned()

    # -- Condition protocol --------------------------------------------------

    def _release_save(self):
        self._san._on_release(self.name)
        fn = getattr(self._inner, "_release_save", None)
        if fn is not None:
            return fn()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        fn = getattr(self._inner, "_acquire_restore", None)
        if fn is not None:
            fn(state)
        else:
            self._inner.acquire()
        self._san._on_acquire(self.name, _call_site())

    def _is_owned(self) -> bool:
        fn = getattr(self._inner, "_is_owned", None)
        if fn is not None:
            return fn()
        # plain-Lock fallback: CPython's Condition uses the same probe
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


# -- active-sanitizer management + factories --------------------------------

_ACTIVE: LockSanitizer | None = None
_ACTIVE_MU = threading.Lock()


def current() -> LockSanitizer | None:
    """The active sanitizer: one installed by :func:`sanitize`, else a
    process-global instance auto-created when ``REPRO_LOCKSAN`` is set,
    else None."""
    global _ACTIVE
    if _ACTIVE is None and enabled():
        with _ACTIVE_MU:
            if _ACTIVE is None:
                _ACTIVE = LockSanitizer()
    return _ACTIVE


@contextlib.contextmanager
def sanitize(*, hold_ms: float = DEFAULT_HOLD_MS):
    """Force-activate a fresh sanitizer for the scope (tests), regardless
    of the environment; locks must be *created* inside the scope to be
    instrumented."""
    global _ACTIVE
    prev = _ACTIVE
    san = LockSanitizer(hold_ms=hold_ms)
    with _ACTIVE_MU:
        _ACTIVE = san
    try:
        yield san
    finally:
        with _ACTIVE_MU:
            _ACTIVE = prev


def _maybe_wrap(inner, name: str | None):
    san = current()
    if san is None:
        return inner
    return _SanLock(inner, name or f"lock@{_call_site()}", san)


def new_lock(name: str | None = None):
    """A ``threading.Lock``, sanitizer-wrapped when one is active."""
    return _maybe_wrap(threading.Lock(), name)


def new_rlock(name: str | None = None):
    """A ``threading.RLock``, sanitizer-wrapped when one is active."""
    return _maybe_wrap(threading.RLock(), name)


def new_condition(name: str | None = None):
    """A ``threading.Condition`` over a (possibly wrapped) RLock; wait()
    windows pause the wrapped lock's hold clock via the Condition
    protocol hooks on :class:`_SanLock`."""
    return threading.Condition(new_rlock(name))
