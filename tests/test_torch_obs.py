"""The span recorder (``repro_torch.obs``) and the spans of the serving
path: off it records nothing and allocates nothing; on it nests, names
threads, drains, bounds itself and records collections; a refresh
through ``Server`` over ``GNNServeEngine`` gives the span tree the
benchmark's readers expect."""
import gc
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                 SchedulerConfig, Server)


@pytest.fixture
def recorder():
    """The recorder on for the test, off and empty after it."""
    obs.drain()
    obs.enable()
    try:
        yield obs
    finally:
        obs.disable()
        obs.drain()


def _names(records):
    return [r[0] for r in records]


def test_off_records_nothing_and_returns_one_shared_object():
    assert not obs.enabled()
    a, b = obs.span("server.step"), obs.span("runtime.copy")
    assert a is b
    with a:
        a.end()
    b.close()
    assert obs.drain() == ([], 0)


def test_nesting_threads_and_drain(recorder):
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    worker = threading.Thread(target=lambda: obs.span("there").close(),
                              name="worker-7")
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    records, dropped = obs.drain()
    mine = [r for r in records if not r[0].startswith("python.gc")]
    assert _names(mine) == ["inner", "outer", "there"]   # order of closing
    (_, th_i, i0, i1), (_, th_o, o0, o1), (_, th_w, _, _) = mine
    assert o0 <= i0 <= i1 <= o1
    assert th_i == th_o == threading.current_thread().name
    assert th_w == "worker-7"
    assert dropped == 0
    assert obs.drain() == ([], 0)


def test_end_stamps_and_a_span_closed_after_disable_is_lost(recorder):
    s = obs.span("server.lock_wait")
    s.end()
    t_end = s.t1
    time.sleep(0.002)
    s.close()
    records, _ = obs.drain()
    assert [r for r in records if r[0] == "server.lock_wait"][0][3] == t_end
    late = obs.span("late")
    obs.disable()
    late.close()
    assert "late" not in _names(obs.drain()[0])


def test_bound_counts_drops(recorder, monkeypatch):
    gc.disable()            # no collection record may take a slot
    try:
        monkeypatch.setattr(obs, "CAPACITY", 3)
        for k in range(5):
            obs.span(f"s{k}").close()
        first = obs.drain()
        obs.span("s5").close()
        second = obs.drain()
    finally:
        gc.enable()
    assert (_names(first[0]), first[1]) == (["s0", "s1", "s2"], 2)
    assert (_names(second[0]), second[1]) == (["s5"], 0)


def test_gc_is_recorded_until_disable(recorder):
    gc.collect()
    records, _ = obs.drain()
    got = [r for r in records if r[0] == "python.gc.gen2"]
    assert len(got) == 1 and got[0][2] <= got[0][3]
    assert got[0][1] == threading.current_thread().name
    obs.disable()
    gc.collect()
    assert not obs.drain()[0]


def test_many_threads_lose_no_record(recorder):
    """16 threads on a short switch interval: every span is kept."""
    per, n = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [obs.span("x").close()
                                               for _ in range(per)])
              for _ in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    records, dropped = obs.drain()
    assert _names(records).count("x") == per * n and dropped == 0


# -- the serving path ----------------------------------------------------------

REFRESH_SPANS = ("server.reload", "server.lock_wait", "engine.reload_params",
                 "server.queue", "server.step", "engine.step",
                 "runtime.forward", "runtime.copy", "runtime.softmax",
                 "runtime.answer")


@pytest.fixture(scope="module")
def served():
    g = make_dataset("cora", seed=0, scale=0.1)
    engine = GNNServeEngine(device="cpu", max_shard_n=64)
    engine.register_graph("g", g)
    engine.register_model("m", ZooSpec("gcn", g.profile.feature_dim, 16,
                                       g.profile.num_classes))
    server = Server(engine, SchedulerConfig(max_batch_size=8)).start()
    all_ids = np.arange(g.profile.num_nodes, dtype=np.int64)
    assert isinstance(server.submit(NodeRequest("g", all_ids, "m")).result(
        timeout_s=60), Completed)                       # compiled, warm
    yield server, all_ids
    server.stop(drain=True)


def test_a_refresh_gives_the_span_tree(served, recorder):
    server, all_ids = served
    params = server.engine.model_params("m")
    server.reload(lambda e: e.reload_params("m", params))
    t_submit0 = time.perf_counter()
    ticket = server.submit(NodeRequest("g", all_ids, "m"))
    t_submit1 = time.perf_counter()
    assert isinstance(ticket.result(timeout_s=60), Completed)
    records, dropped = obs.drain()
    records = [r for r in records if not r[0].startswith("python.gc")]
    names = _names(records)
    assert dropped == 0
    for name in REFRESH_SPANS:
        want = 2 if name == "server.lock_wait" else 1   # reload, then step
        assert names.count(name) == want, (name, names)
    assert set(names) == set(REFRESH_SPANS)
    by = {r[0]: r for r in records}
    server_thread = {by[n][1] for n in ("server.step", "engine.step",
                                        "runtime.forward", "runtime.copy",
                                        "runtime.softmax", "runtime.answer")}
    assert server_thread == {"repro-server"}
    assert by["server.reload"][1] == by["engine.reload_params"][1] == \
        threading.current_thread().name

    def inside(inner, outer):
        return by[outer][2] <= by[inner][2] <= by[inner][3] <= by[outer][3]

    assert inside("engine.reload_params", "server.reload")
    assert inside("engine.step", "server.step")
    for n in ("runtime.forward", "runtime.copy", "runtime.softmax",
              "runtime.answer"):
        assert inside(n, "engine.step")
    f, c, s, a = (by[n] for n in ("runtime.forward", "runtime.copy",
                                  "runtime.softmax", "runtime.answer"))
    assert f[3] <= c[2] and c[3] <= s[2] and s[3] <= a[2]
    queue = by["server.queue"]
    assert queue[1] == threading.current_thread().name    # opened by submit
    assert t_submit0 <= queue[2] <= t_submit1
    assert queue[3] <= by["server.step"][2]               # closed at dispatch
    waits = [r for r in records if r[0] == "server.lock_wait"]
    assert {w[1] for w in waits} == {threading.current_thread().name,
                                     "repro-server"}


def test_a_cache_hit_records_no_forward(served, recorder):
    server, all_ids = served
    ticket = server.submit(NodeRequest("g", all_ids[:5], "m"))
    assert isinstance(ticket.result(timeout_s=60), Completed)
    names = _names(obs.drain()[0])
    assert "runtime.answer" in names and "runtime.forward" not in names


def test_idle_polls_record_nothing(served, recorder):
    time.sleep(0.15)            # the server thread polls, dispatches none
    assert [n for n in _names(obs.drain()[0])
            if not n.startswith("python.gc")] == []
