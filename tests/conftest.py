"""Shared test configuration.

The property tests use ``hypothesis`` when it is installed (see
requirements-dev.txt). In minimal environments without it, importing the
test modules used to *error* at collection and take the whole tier-1 run
down with them. Instead we install a deterministic mini-fallback into
``sys.modules`` before collection: ``@given`` runs each test over a small,
fixed sample of its strategies (diagonal sampling across the example
lists), and ``@settings`` becomes a no-op. Real hypothesis, when present,
always wins.
"""
from __future__ import annotations

import functools
import inspect
import itertools
import sys
import types

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test (subprocess runs)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    _MAX_RUNS = 8

    class _Strategy:
        """A strategy is just a fixed, ordered list of example values."""

        def __init__(self, examples):
            self.examples = list(examples)
            if not self.examples:
                raise ValueError("strategy needs at least one example")

    def _sampled_from(seq):
        return _Strategy(seq)

    def _integers(min_value=0, max_value=0):
        mid = (min_value + max_value) // 2
        return _Strategy(dict.fromkeys([min_value, mid, max_value]))

    def _booleans():
        return _Strategy([False, True])

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        mid = 0.5 * (min_value + max_value)
        return _Strategy(dict.fromkeys([min_value, mid, max_value]))

    def _given(*arg_strategies, **kw_strategies):
        if arg_strategies:
            raise TypeError(
                "fallback @given supports keyword strategies only")

        def deco(fn):
            names = list(kw_strategies)
            exs = [kw_strategies[n].examples for n in names]
            # enumerate the full cartesian product (strategies here carry a
            # handful of examples each) and take evenly spaced combos, so
            # mixed off-diagonal combinations are exercised too
            combos = list(itertools.product(*exs))
            step = max(1, len(combos) // _MAX_RUNS)
            picked = combos[::step][:_MAX_RUNS]

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                for combo in picked:
                    fn(*args, **dict(zip(names, combo)), **kwargs)

            # pytest resolves fixtures from the *wrapped* signature; strip
            # the strategy-bound parameters so they aren't mistaken for
            # fixtures (and drop __wrapped__, which would leak them back)
            sig = inspect.signature(fn)
            params = [p for p in sig.parameters.values()
                      if p.name not in kw_strategies]
            wrapper.__signature__ = sig.replace(parameters=params)
            del wrapper.__wrapped__
            wrapper.hypothesis_fallback = True
            return wrapper

        return deco

    def _settings(*_a, **_kw):
        def deco(fn):
            return fn

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.sampled_from = _sampled_from
    _st.integers = _integers
    _st.booleans = _booleans
    _st.floats = _floats

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(all=staticmethod(lambda: []))
    _hyp.__fallback__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
