"""BENCHMARK.json: its format, and every cell and metric resolved to the
files that hold it; a configuration, traffic mix and metric added as
files are picked up with no edit to a file that is there."""
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
