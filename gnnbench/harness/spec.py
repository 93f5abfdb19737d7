"""What ``BENCHMARK.json`` names, resolved to the files that hold it.

Every piece sits in a file of its own that is found by its name, so a
cell, configuration, traffic mix or metric is added by adding files and
entries, never by editing one:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  whose ``arch`` names its plain reference ``reference/<arch>.py`` (which
  declares the parameters the driver draws) and its counts
  ``counts/<arch>.py`` (loaded by path by the metrics that read them);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's limits for the comparison that decides ``correct``:
  ``limits/<workload>.json``;
- a metric, end to end or per layer: its reader ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent   # gnnbench/


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str              # "end_to_end" | "per_layer"
    entry: dict
    reader: object         # the module; read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: object      # the config's plain reference module
    metrics: list[Metric]

    def metrics_of(self, kind: str) -> list[Metric]:
        return [m for m in self.metrics if m.kind == kind]


def load_module(path: pathlib.Path, name: str):
    """Import the file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def reader_path(metric_name: str, base: pathlib.Path = HERE) -> pathlib.Path:
    return base / "metrics" / f"{metric_name}.py"


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(root: pathlib.Path, workload: str,
            base: pathlib.Path = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with every file it
    needs; ``base`` is the directory that holds the benchmark's files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _read_json(root / cfg_entry["file"])
    traffic = _read_json(base / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(base / "limits" / f"{workload}.json")
    reference = load_module(base / "reference" / f"{config['arch']}.py",
                            f"gnnbench_reference_{config['arch']}")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for entry in bench[kind]:
            if not _applies(entry, workload):
                continue
            path = reader_path(entry["name"], base)
            module = load_module(path, "gnnbench_metric_"
                                 + entry["name"].replace(".", "_"))
            metrics.append(Metric(entry["name"], entry["unit"], kind, entry,
                                  module))
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, limits, reference, metrics)
