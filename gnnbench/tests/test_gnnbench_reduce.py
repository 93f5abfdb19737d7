"""The arithmetic of the metrics: spreads, the refresh time, the device
trace's busy time and gaps, and the kernel roofline's reading of it."""
import math
import statistics
import types

import pytest

from gnnbench.counts import gcn as counts
from gnnbench.harness import reduce, spec, stats
from gnnbench.harness.cell import breakdown
from gnnbench.harness.drive import Refresh, Run
from gnnbench.harness.peaks import H100_SXM
from gnnbench.harness.trace import parse


def test_spread():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def _run(**kw):
    run = Run("c", {}, {}, 1.0, "cpu", t_open=100.0, t_close=101.0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_infer_ms_is_the_window_over_the_refreshes():
    rs = [Refresh(i % 2, 100 + i * 0.01, 100 + i * 0.01, 100.01 + i * 0.01,
                  "completed") for i in range(50)]
    run = _run(refreshes=rs)
    assert reduce.refresh_ms(run) == pytest.approx(10.0)


def _doc(events, base_ns=1_000_000_000_000):
    return {"baseTimeNanoseconds": base_ns, "traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events] + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}]}


def test_trace_busy_time_and_gaps():
    # wall clock = base + ts µs; perf_counter = wall - offset
    offset = 1000.0 - 10.0
    doc = _doc([("kernel", "a", 100.0, 50.0), ("kernel", "b", 120.0, 50.0),
                ("gpu_memcpy", "Memcpy DtoH", 500.0, 100.0)])
    tr = parse(doc, offset, t0=10.0, t1=10.001)
    assert tr.busy_s == pytest.approx(170e-6)
    assert tr.window_s == pytest.approx(1e-3)
    gaps = tr.gaps()
    assert gaps[:, 1] - gaps[:, 0] == pytest.approx(
        [100e-6, 330e-6, 400e-6], abs=1e-9)
    start, dur = tr.ops("Memcpy")
    assert dur.tolist() == [100e-6]
    names = dict(tr.time_by_name())
    assert names["a"] == pytest.approx(50e-6)


def test_roofline_reads_two_launches_a_forward():
    dims, nodes, nnz = [500, 16, 3], 1000, 5000
    b = [counts.layer_bound_s(*layer, H100_SXM)
         for layer in counts.network_layers(nodes, nnz, dims)]
    events = []
    for k in range(3):           # three forwards, layer 0 then layer 1
        events += [("kernel", "fused_gnn_kernel<32, true>", k * 1000.0, 20.0),
                   ("kernel", "fused_gnn_kernel<16, false>", k * 1000 + 30.0,
                    5.0)]
    tr = parse(_doc(events), 0.0, t0=1000.0, t1=1000.01)
    run = _run(trace=tr, peaks=H100_SXM, num_nodes=nodes, nnz=nnz, dims=dims,
               launches=({"fused_gnn": 0}, {"fused_gnn": 6}),
               engine=({"logits_cache_misses": 4},
                       {"logits_cache_misses": 7}))
    read = spec.load_module(spec.reader_path("fused_gnn_roofline"),
                            "t_roof").read
    assert read(run) == pytest.approx(100 * 3 * sum(b) / 75e-6)
    run.launches = ({"fused_gnn": 0}, {"fused_gnn": 7})   # an extra launch
    assert read(run) is None
    run.peaks = None
    assert read(run) is None


def test_breakdown_names_gaps_by_host_activity():
    doc = _doc([("kernel", "k", 0.0, 100.0), ("kernel", "k", 900.0, 100.0)])
    tr = parse(doc, 1000.0 - 100.0, t0=100.0, t1=100.001)
    run = _run(trace=tr, refreshes=[Refresh(0, 100.0, 100.0002, 100.0008,
                                            "completed")])
    out = breakdown(run)
    assert out["device_ops"] == [["k", pytest.approx(200e-6)]]
    assert out["idle_gaps"][0][0] == "server: refresh request, host side"
    assert out["idle_gaps"][0][1] == pytest.approx(800e-6)
    assert all(isinstance(g[0], str) for g in out["idle_gaps"])
    assert not math.isnan(out["idle_gaps"][0][1])


def test_idle_share_reader():
    tr = types.SimpleNamespace(busy_s=0.25, window_s=1.0)
    run = _run(trace=tr)
    read = spec.load_module(spec.reader_path("idle_share.infer"),
                            "t_idle").read
    assert read(run) == pytest.approx(75.0)
    assert read(_run()) is None


def test_gap_named_by_what_covers_most_of_it():
    from gnnbench.harness.cell import host_activity

    rs = [Refresh(0, 100.0 + k * 1e-4, 100.0 + k * 1e-4 + 2e-5,
                  100.0 + k * 1e-4 + 8e-5, "completed") for k in range(10)]
    run = _run(refreshes=rs)
    # requests cover 0.6 of [100, 100.001], pushes 0.2
    assert host_activity(run, 100.0, 100.001) == \
        "server: refresh request, host side"
    assert host_activity(run, 100.0, 100.00002) == "engine: Server.reload"
    assert host_activity(run, 101.0, 101.5) == "driver: no work due"
