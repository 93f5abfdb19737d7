"""Readings for the limits of ``correct``: one cell run on many seeds in
one process, each with the control (the reference in TF32 put in the
program's place) read on the same answers.

    python3 gnnbench/tools/readings.py --workload gcn-pubmed.refresh \
        --seeds 11,12,13 --seconds 10

Prints one JSON line per seed: the program's ``answer_err`` and
``unanswered``, the control's ``control_answer_err``, how many answers
were compared, and the end-to-end metrics of that run.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gnnbench.harness import cell

    t0 = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers, run = cell.run_cell(ROOT, args.workload, seed=seed,
                                        seconds=args.seconds, trace=False,
                                        device="cuda", t_process=t0,
                                        control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **numbers, "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v
                                      in result["metrics"].items()}}),
              flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
