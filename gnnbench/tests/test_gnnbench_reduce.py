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


def test_infer_mfu_of_a_gcn_run_is_the_gcn_count():
    """The whole step's share reads the run's architecture's counts; for
    gcn it is the number ``counts/gcn.py`` gave it directly."""
    dims, nodes, nnz = [602, 16, 41], 23296, 11484884
    rs = [Refresh(i % 2, 100 + i * 0.02, 100 + i * 0.02, 100.017 + i * 0.02,
                  "completed") for i in range(40)]
    run = _run(config={"arch": "gcn"}, refreshes=rs, trace=object(),
               peaks=H100_SXM, num_nodes=nodes, nnz=nnz, dims=dims)
    read = spec.load_module(spec.reader_path("infer_mfu"), "t_mfu").read
    ms = reduce.refresh_ms(run)
    assert read(run) == \
        100.0 * counts.network_bound_s(nodes, nnz, dims, H100_SXM) / (ms / 1e3)
    run.trace = None
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


def _kernel_run(refreshes=4):
    """Four completed refreshes; the trace holds two kernels of 20 µs and
    5 µs a refresh, a DtoH copy of 50 µs and a memset of 1 µs."""
    events = []
    for k in range(refreshes):
        events += [("kernel", "fused_gnn_kernel<true, true>", k * 1000.0, 20.0),
                   ("kernel", "fused_gnn_kernel<false, true>", k * 1000 + 30.0,
                    5.0),
                   ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                    k * 1000 + 40.0, 50.0),
                   ("gpu_memset", "Memset (Device)", k * 1000 + 95.0, 1.0)]
    tr = parse(_doc(events), 0.0, t0=1000.0, t1=1000.01)
    rs = [Refresh(i % 2, 100 + i * 0.02, 100 + i * 0.02, 100.017 + i * 0.02,
                  "completed") for i in range(refreshes)]
    return _run(config={"arch": "gcn"}, trace=tr, refreshes=rs)


def test_kernel_ms_is_the_kernels_device_time_over_the_refreshes():
    run = _kernel_run()
    assert run.trace.kernel_s() == pytest.approx(4 * 25e-6)
    read = spec.load_module(spec.reader_path("kernel_ms"), "t_kms").read
    assert read(run) == pytest.approx(0.025)
    run.refreshes[-1].outcome = "expired"         # over the completed ones
    assert read(run) == pytest.approx(4 * 0.025 / 3)
    assert read(_run(refreshes=run.refreshes)) is None      # no trace
    run.trace = parse(_doc([("gpu_memcpy", "Memcpy", 0.0, 9.0)]), 0.0,
                      t0=1000.0, t1=1000.01)
    assert read(run) is None                      # no kernel ran


def test_kernel_mfu_is_the_gcn_count_over_the_kernel_time():
    dims, nodes, nnz = [602, 16, 41], 23296, 11484884
    run = _kernel_run()
    run.peaks, run.num_nodes, run.nnz, run.dims = H100_SXM, nodes, nnz, dims
    read = spec.load_module(spec.reader_path("kernel_mfu"), "t_kmfu").read
    assert read(run) == pytest.approx(
        100.0 * counts.network_bound_s(nodes, nnz, dims, H100_SXM) / 25e-6)
    run.peaks = None
    assert read(run) is None


def test_refresh_ms_reads_the_window_over_the_refreshes():
    """refresh_ms, end to end before as infer_ms, is the closed loop's
    window over its completed refreshes."""
    rs = [Refresh(i % 2, 100 + i * 0.01, 100 + i * 0.01, 100.01 + i * 0.01,
                  "completed") for i in range(50)]
    read = spec.load_module(spec.reader_path("refresh_ms"), "t_rms").read
    assert read(_run(refreshes=rs)) == pytest.approx(10.0)
    rs[-1].outcome = "expired"
    assert read(_run(refreshes=rs)) == pytest.approx(
        (rs[-2].t_done - 100.0) / 49 * 1e3)
    assert read(_run()) is None


@pytest.mark.parametrize("trace_flag, workload, device, traced", [
    (False, "gcn-reddit01.refresh", "cuda", True),    # kernel_ms: a trace
    (False, "gcn-pubmed.refresh", "cuda", True),
    (True, "gcn-pubmed.refresh", "cuda", True),
    (False, "gcn-reddit01.refresh", "cpu", False),    # no device to trace
])
def test_the_window_is_traced_where_an_end_to_end_metric_reads_the_device(
        trace_flag, workload, device, traced):
    import pathlib

    from gnnbench.harness.drive import Driver

    root = pathlib.Path(__file__).resolve().parents[2]
    cell = spec.resolve(root, workload)
    driver = Driver(cell, 1, 1.0, device, trace_flag, 0.0)
    assert driver.traces_window is traced
    assert driver.tracing is trace_flag               # the span recorder
