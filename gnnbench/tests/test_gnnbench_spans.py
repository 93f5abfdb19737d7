"""The program's spans in a traced run: the readers of the six span
metrics on a run with known spans, the self-interval reduction, the
naming of idle gaps, a program without a recorder (every reader None,
the breakdown as before), and a traced run on the CPU end to end with
the profiler stood in for: the driver records the spans whatever readers
the cell lists, and loading a reader patches nothing."""
import json
import sys
import time

import numpy as np
import pytest

from gnnbench.harness import cell, spans, spec, trace
from gnnbench.harness.drive import Refresh, Run

from gnnbench_tiny import make_root

READERS = ("reload_ms", "handoff_ms", "forward_host_ms", "logits_host_ms",
           "gc_ms", "idle_untraced.infer")
M, S = "MainThread", "repro-server"


def _read(name, run):
    return spec.load_module(spec.reader_path(name),
                            "t_" + name.replace(".", "_")).read(run)


def _trace(kernels, t0=100.0, t1=101.0):
    start = np.asarray([a for a, _ in kernels], dtype=float)
    dur = np.asarray([b - a for a, b in kernels], dtype=float)
    return trace.DeviceTrace(["k"] * len(kernels), start, dur, t0, t1)


RECORDS = [
    ("server.lock_wait", M, 100.00, 100.02),
    ("engine.reload_params", M, 100.02, 100.09),
    ("server.reload", M, 100.00, 100.10),
    ("server.queue", M, 100.10, 100.15),
    ("runtime.forward", S, 100.17, 100.20),
    ("python.gc.gen0", S, 100.25, 100.26),
    ("runtime.copy", S, 100.20, 100.30),
    ("runtime.softmax", S, 100.30, 100.40),
    ("runtime.answer", S, 100.40, 100.45),
    ("engine.step", S, 100.16, 100.49),
    ("server.step", S, 100.15, 100.50),
    ("python.gc.gen2", M, 99.90, 100.00),      # before the window
    ("python.gc.gen2", M, 100.95, 101.05),     # half in it
]


def _run(records=RECORDS, dropped=0):
    run = Run("c", {}, {}, 1.0, "cpu", t_open=100.0, t_close=101.0)
    run.refreshes = [Refresh(0, 100.0, 100.1, 100.5, "completed"),
                     Refresh(1, 100.5, 100.6, 100.9, "completed")]
    run.trace = _trace([(100.18, 100.28)])
    if records is not None:
        run.spans = spans.Spans(list(records), dropped)
    return run


def test_readers_on_known_spans():
    run = _run()
    want = {"reload_ms": 100 / 2, "handoff_ms": 50 / 2,
            "forward_host_ms": 30 / 2, "logits_host_ms": 150 / 2,
            "gc_ms": (10 + 50) / 2,
            # idle 0.18 + 0.72 s; spans cover 0.18 + 0.22 + 0.05 of it
            "idle_untraced.infer": 100 * (0.90 - 0.45) / 0.90}
    for name in READERS:
        assert _read(name, run) == pytest.approx(want[name]), name


@pytest.mark.parametrize("run", [_run(records=None), _run(dropped=3),
                                 Run("c", {}, {}, 1.0, "cpu")],
                         ids=["no recorder", "dropped", "untraced"])
def test_readers_read_nothing_without_whole_spans(run):
    assert [_read(name, run) for name in READERS] == [None] * len(READERS)


def test_self_intervals():
    got = spans.self_intervals([
        ("outer", "t", 0.0, 3.0), ("inner", "t", 0.0, 1.0),
        ("late", "t", 2.0, 4.0),                  # overlaps outer's end
        ("other", "u", 0.5, 1.5)])
    assert sorted(got) == [("inner", "t", 0.0, 1.0), ("late", "t", 2.0, 4.0),
                           ("other", "u", 0.5, 1.5), ("outer", "t", 1.0, 2.0)]
    run = _run()
    self_ms = spans.self_ms(run)
    assert self_ms[(S, "runtime.copy")] == pytest.approx(90 / 2)
    assert self_ms[(S, "engine.step")] == pytest.approx(50 / 2)
    assert self_ms[(M, "server.reload")] == pytest.approx(10 / 2)
    # the self times tile the union of the spans
    assert sum(self_ms.values()) == pytest.approx((500 + 50) / 2)


def test_gaps_named_by_the_innermost_span_else_by_the_loop():
    run = _run()
    assert cell.host_activity(run, 100.0, 100.18) == \
        f"program {M}: engine.reload_params"
    assert cell.host_activity(run, 100.28, 101.0) == \
        f"program {S}: runtime.softmax"
    assert cell.host_activity(run, 100.25, 100.26) == \
        f"program {S}: python.gc.gen0"
    # past every span: the closed loop's own names
    assert cell.host_activity(run, 101.5, 102.0) == \
        cell.loop_activity(run, 101.5, 102.0)
    assert not cell.host_activity(run, 101.5, 102.0).startswith("program")
    names = [name for name, _ in cell.breakdown(run)["idle_gaps"]]
    assert names == [f"program {S}: runtime.softmax",
                     f"program {M}: engine.reload_params"]


def test_without_a_recorder_the_breakdown_is_the_loops(monkeypatch):
    run = _run(records=None)
    named = cell.breakdown(run)
    monkeypatch.setattr(cell, "host_activity", cell.loop_activity)
    assert cell.breakdown(run) == named
    assert [n for n, _ in named["idle_gaps"]] == [
        "server: refresh request, host side", "engine: Server.reload"]


# -- whole runs on the CPU at the tiny size ------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _stand_in_profiler(monkeypatch):
    """A profiler that traces no device: the whole window is one gap."""

    def start(tracer):
        tracer._t0 = time.perf_counter()

    def stop(tracer):
        return _trace([], tracer._t0, time.perf_counter())

    monkeypatch.setattr(trace.Tracer, "start", start)
    monkeypatch.setattr(trace.Tracer, "stop", stop)


def _cell(root, trace_on):
    return cell.run_cell(root, "gcn-pubmed.refresh", seed=2 ** 31 + 5,
                         seconds=0.6, trace=trace_on, device="cpu",
                         t_process=time.perf_counter(),
                         base=root / "gnnbench")


def test_a_traced_run_reads_every_span_metric(root, monkeypatch):
    from repro_torch import obs

    _stand_in_profiler(monkeypatch)
    result, _, run = _cell(root, True)
    assert result["correct"]
    for name in READERS:
        assert name in result["metrics"], name
    assert not obs.enabled() and obs.drain() == ([], 0)
    assert run.spans.dropped == 0
    gap, = result["breakdown"]["idle_gaps"]
    assert gap[0].startswith("program ")


def test_a_traced_run_of_a_program_without_a_recorder(root, monkeypatch):
    import repro_torch

    _stand_in_profiler(monkeypatch)
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    result, _, run = _cell(root, True)
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    assert run.spans is None
    gap, = result["breakdown"]["idle_gaps"]
    assert not gap[0].startswith("program ")


def test_an_untraced_run_never_switches_the_recorder_on(root, monkeypatch):
    from repro_torch import obs

    def refuse():
        raise AssertionError("obs.enable called in a --trace 0 run")

    monkeypatch.setattr(obs, "enable", refuse)
    result, _, run = _cell(root, False)
    assert result["correct"] and run.trace is None
    assert not obs.enabled()


def test_an_untraced_run_reading_the_device_keeps_the_recorder_off(
        root, monkeypatch):
    """kernel_ms has the driver trace the device in a --trace 0 run; the
    span recorder stays off all the same."""
    from repro_torch import obs

    def refuse():
        raise AssertionError("obs.enable called in a --trace 0 run")

    _stand_in_profiler(monkeypatch)
    monkeypatch.setattr(trace.Tracer, "can_trace",
                        staticmethod(lambda device: True))
    monkeypatch.setattr(obs, "enable", refuse)
    result, _, run = _cell(root, False)
    assert result["correct"] and run.trace is not None and run.spans is None
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert not obs.enabled()


def test_set_up_leaves_out_the_profilers_start(root, monkeypatch):
    """setup_s is the program's set-up: a profiler that takes 0.3 s to
    start lies between its end and the window's opening."""
    _stand_in_profiler(monkeypatch)
    started = trace.Tracer.start

    def slow_start(tracer):
        time.sleep(0.3)
        started(tracer)

    monkeypatch.setattr(trace.Tracer, "start", slow_start)
    t_process = time.perf_counter()
    result, _, run = cell.run_cell(root, "gcn-pubmed.refresh", seed=7,
                                   seconds=0.3, trace=True, device="cpu",
                                   t_process=t_process,
                                   base=root / "gnnbench")
    assert result["correct"]
    assert run.t_open - t_process - run.setup_s >= 0.3


def test_loading_the_readers_patches_nothing():
    plain = (trace.Tracer.start, trace.Tracer.stop, cell.host_activity)
    for name in READERS:
        _read(name, _run())
    assert (trace.Tracer.start, trace.Tracer.stop, cell.host_activity) == \
        plain
    assert not hasattr(spans, "install")


def test_a_traced_run_records_spans_whatever_readers_the_cell_lists(
        tmp_path, monkeypatch):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] == "idle_share.infer"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _stand_in_profiler(monkeypatch)
    result, _, run = _cell(root, True)
    assert result["correct"] and set(result["metrics"]) == {"idle_share.infer"}
    assert run.spans.records and run.spans.dropped == 0
    gap, = result["breakdown"]["idle_gaps"]
    assert gap[0].startswith("program ")
