"""Spreads of a cell's end-to-end metrics over two sets of runs, and the
bound they support.

    python3 gnnbench/tools/spread.py setA/*.out -- setB/*.out

Each file's last line is one run's result line. For each metric: each
set's median and spread (the distance between the first and third
quartile as a share of the median, ``statistics.quantiles(n=4)``), the
same with each set's run farthest from its median left out, the
second set's median against the first's, and five times the wider
spread (never under 1%), the bound these runs support.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from gnnbench.harness.stats import spread  # noqa: E402


def _values(paths: list[str]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for p in paths:
        lines = pathlib.Path(p).read_text().strip().splitlines()
        result = json.loads(lines[-1])
        for name, m in result["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def _trimmed(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def report(set_a: list[str], set_b: list[str]) -> dict:
    a, b = _values(set_a), _values(set_b)
    out = {}
    for name in sorted(set(a) & set(b)):
        sa, sb = spread(a[name]), spread(b[name])
        wide = max(sa, sb)
        out[name] = {
            "median_a": statistics.median(a[name]),
            "median_b": statistics.median(b[name]),
            "spread_a": sa, "spread_b": sb,
            "trimmed_mean_spread": (spread(_trimmed(a[name]))
                                    + spread(_trimmed(b[name]))) / 2,
            "b_over_a": statistics.median(b[name]) / statistics.median(a[name]),
            "bound": max(0.01, 5 * wide)}
    return out


def main() -> int:
    args = sys.argv[1:]
    cut = args.index("--")
    for name, row in report(args[:cut], args[cut + 1:]).items():
        print(json.dumps({"metric": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
