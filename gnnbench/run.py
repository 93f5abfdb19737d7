"""Run one cell of the benchmark once and print its result line.

    python3 gnnbench/run.py --workload gcn-reddit01.refresh --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout. Needs as many CUDA cards as the cell asks
for, and exits with code 2 and no result without them. The last line of
standard output is the result object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number beside its limit); the last
lines of standard error repeat the checks.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from gnnbench.harness import spec

    bench = spec.benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from gnnbench.harness import cell

    result, _, run = cell.run_cell(ROOT, args.workload, seed=args.seed,
                                   seconds=args.seconds,
                                   trace=bool(args.trace), device="cuda",
                                   t_process=T_PROCESS)
    print("set-up: " + ", ".join(f"{name} {t:.3f} s"
                                 for name, t in run.setup_steps),
          file=sys.stderr)
    found = cell.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the torch "
              f"port alone", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
