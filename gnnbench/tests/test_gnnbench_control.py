"""On the card: the control, the reference in TF32 put in the program's
place, fails the limit that the program meets, at each cell's own size
with 2 s windows. Skips without a card; run on the card with
``python -m pytest -m cuda gnnbench/tests``."""
import pathlib
import time

import pytest
import torch

from gnnbench.harness import cell

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda gnnbench/tests)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gcn-pubmed.refresh",
                                      "gcn-reddit01.refresh"])
def test_control_fails_where_the_program_passes(cuda, workload):
    result, numbers, _ = cell.run_cell(REPO, workload, seed=2024,
                                       seconds=2.0, trace=False, device=cuda,
                                       t_process=time.perf_counter(),
                                       control=True)
    limit = result["checks"]["answer_err"]["limit"]
    assert result["correct"], numbers
    assert numbers["control_answer_err"] > limit, numbers
