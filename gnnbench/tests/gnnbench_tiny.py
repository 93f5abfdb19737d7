"""A benchmark root at a size the CPU runs in seconds, for the tests: the
real BENCHMARK.json and gnnbench/ files, with each configuration cut to a
small graph and shard size."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY = {
    "gcn-pubmed": {"scale": 0.05, "num_nodes": 985, "num_edges": 4432,
                   "max_shard_n": 128},
    "gcn-reddit01": {"dataset": "pubmed", "scale": 0.04, "num_nodes": 788,
                     "num_edges": 3545, "feature_dim": 500,
                     "num_classes": 3, "max_shard_n": 128},
}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark under ``tmp`` at the tiny size; returns
    the root (``tmp``), whose ``gnnbench/`` is the base."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "gnnbench", tmp / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    return tmp
