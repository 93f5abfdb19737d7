"""BENCHMARK.json: its format, and every cell and metric resolved to the
files that hold it; a configuration, traffic mix and metric added as
files are picked up with no edit to a file that is there, and so is an
architecture (gin: its reference, counts, configuration and limits)."""
import json
import pathlib
import re
import shutil
import time

import pytest

from gnnbench.harness import cell, spec

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ALL_CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gnnbench"]
    assert BENCH["command"][:2] == ["python3", "gnnbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keep_to_the_format():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gnnbench/")
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
            + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks():
    for w in ALL_CELLS:
        c = spec.resolve(REPO, w)
        e2e = {m.name for m in c.metrics_of("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = c.metrics_of("per_layer")
        assert per_layer
        for m in per_layer:      # a per-layer metric moves one of the cell's
            assert m.entry["moves"] in e2e


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_cell_resolves_to_its_files(workload):
    c = spec.resolve(REPO, workload)
    assert c.config["name"] == c.config_name
    assert c.traffic and c.limits
    assert set(c.limits) == {"answer_err", "unanswered"}
    assert hasattr(c.reference, "probs")


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_metric_has_a_reader(metric):
    module = spec.load_module(spec.reader_path(metric), "t_" + metric)
    assert callable(module.read)


def test_an_added_config_traffic_and_metric_need_no_edit(tmp_path):
    """A new configuration, traffic mix and metric, as files and entries
    alone, run as a cell of their own; no file already there changes."""
    from gnnbench_tiny import make_root

    root = make_root(tmp_path)
    base = root / "gnnbench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "gcn-pubmed.json").read_text())
    cfg.update(name="gcn-citeseer", dataset="citeseer", scale=0.1,
               num_nodes=332, num_edges=910, feature_dim=3703, num_classes=6)
    (base / "configs" / "gcn-citeseer.json").write_text(json.dumps(cfg))
    (base / "traffic" / "three_sets.json").write_text(json.dumps({
        "server": {"max_batch_size": 4},
        "refresh": {"weight_sets": 3}}))
    (base / "limits" / "gcn-citeseer.three_sets.json").write_text(json.dumps(
        {"answer_err": 1e-5, "unanswered": 0}))
    (base / "metrics" / "refresh_p50_ms.py").write_text(
        "import statistics\n\n\n"
        "def read(run):\n"
        "    return statistics.median((r.t_done - r.t_reload) * 1e3\n"
        "                             for r in run.refreshes)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gcn-citeseer", "source": "x",
                             "file": "gnnbench/configs/gcn-citeseer.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gcn-citeseer.three_sets",
                               "config": "gcn-citeseer",
                               "traffic": "three_sets", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "refresh_p50_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["gcn-citeseer.three_sets"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, run = cell.run_cell(root, "gcn-citeseer.three_sets", seed=3,
                                   seconds=0.5, trace=False, device="cpu",
                                   t_process=time.perf_counter(), base=base)
    assert result["correct"]
    assert {"refresh_p50_ms", "setup_s"} <= set(result["metrics"])
    assert {r.weight_set for r in run.refreshes} == {0, 1, 2}
    after = {p: p.read_bytes() for p in before}
    assert after == before
    shutil.rmtree(root / "gnnbench")


GIN = pathlib.Path(__file__).resolve().parent / "gin"


def _add_gin(root: pathlib.Path) -> str:
    """Add the gin files under ``tests/gin/`` to the root's benchmark,
    cut as the tiny root cuts an added configuration, with entries for
    its configuration and cell and the cell named in the ``workloads``
    of every metric the Pubmed refresh cell reports but gcn's kernel
    roofline."""
    from gnnbench_tiny import DEFAULT

    base = root / "gnnbench"
    for src in GIN.rglob("*"):
        if src.is_file() and src.name != "entries.json":
            dst = base / src.relative_to(GIN)
            assert not dst.exists(), dst
            dst.write_bytes(src.read_bytes())
    path = base / "configs" / "gin-pubmed.json"
    cfg = json.loads(path.read_text())
    cfg.update(DEFAULT)
    path.write_text(json.dumps(cfg))
    entries = json.loads((GIN / "entries.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += entries["configs"]
    bench["workloads"] += entries["workloads"]
    workload, = (w["name"] for w in entries["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gcn-pubmed.refresh" in m.get("workloads", []) and \
                not m["name"].startswith("fused_gnn_roofline"):
            m["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload


def _zero_in_pushes(monkeypatch, key: str) -> None:
    """Make a weight push set ``key`` of every layer to zero inside the
    program, on a copy of the pushed tree."""
    import torch

    from repro_torch.serving.gnn_engine import GNNServeEngine

    plain = GNNServeEngine.reload_params

    def reload_params(self, model, params):
        layers = [{k: torch.zeros_like(v) if k == key else v
                   for k, v in layer.items()} for layer in params["layers"]]
        return plain(self, model, {"layers": layers})

    monkeypatch.setattr(GNNServeEngine, "reload_params", reload_params)


def _stand_in_device_profiler(monkeypatch):
    """A profiler that traces a device on the CPU: one kernel of 1 ms in
    the window, so the device-trace metrics have something to read."""
    import numpy as np

    from gnnbench.harness import trace

    def start(tracer):
        tracer._t0 = time.perf_counter()

    def stop(tracer):
        t1 = time.perf_counter()
        return trace.DeviceTrace(["k"], np.array([tracer._t0]),
                                 np.array([1e-3]), tracer._t0, t1, ["kernel"])

    monkeypatch.setattr(trace.Tracer, "can_trace", staticmethod(lambda d: True))
    monkeypatch.setattr(trace.Tracer, "start", start)
    monkeypatch.setattr(trace.Tracer, "stop", stop)


@pytest.mark.parametrize("zeroed", [None, "b1", "eps"])
def test_an_added_architecture_needs_no_edit(tmp_path, monkeypatch, zeroed):
    """gin, added as its reference, counts, configuration and limits, runs
    as a cell and comes out correct; with ``b1`` or ``eps`` zeroed inside
    the program it does not. No file already in the root changes."""
    from gnnbench_tiny import make_root

    from gnnbench.harness.peaks import H100_SXM

    root = make_root(tmp_path)
    base = root / "gnnbench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    workload = _add_gin(root)
    _stand_in_device_profiler(monkeypatch)
    if zeroed:
        _zero_in_pushes(monkeypatch, zeroed)
    result, numbers, run = cell.run_cell(root, workload, seed=2 ** 31 + 9,
                                         seconds=0.5, trace=False,
                                         device="cpu",
                                         t_process=time.perf_counter(),
                                         base=base)
    assert {p: p.read_bytes() for p in before} == before
    assert numbers["compared"] > 0 and numbers["unanswered"] == 0
    assert {"kernel_ms", "setup_s"} <= set(result["metrics"])
    if zeroed:
        assert not result["correct"], numbers
        assert numbers["answer_err"] > result["checks"]["answer_err"]["limit"]
        return
    assert result["correct"], numbers
    # the whole step's share reads gin's counts from the root
    run.peaks, run.trace, run.nnz = H100_SXM, object(), 4000
    gin = spec.load_module(base / "counts" / "gin.py", "t_gin_counts")
    mfu = spec.load_module(spec.reader_path("infer_mfu", base), "t_gin_mfu")
    want = gin.network_bound_s(run.num_nodes, 4000, run.dims, H100_SXM)
    assert mfu.read(run) == \
        pytest.approx(100.0 * want / (mfu.refresh_ms(run) / 1e3))
    shutil.rmtree(base)
