"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at the tiny size (``gnnbench_tiny``), with one fault
planted in the program: a step that leaves its state unchanged (a weight
push that does not take), half of a batch left out and the rest scaled
up in its place (half of each node's neighbours in the aggregation; half
of a refresh's rows answered from the other half), and an answer altered
where it is produced. The exchange between chips is a fault no cell can
have: every cell runs on one card.
"""
import time

import numpy as np
import pytest
import torch

from gnnbench.harness import cell
from repro_torch.kernels import ref
from repro_torch.runtime.executable import Executable
from repro_torch.serving.gnn_engine import GNNServeEngine

from gnnbench_tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, seed=11):
    result, numbers, _ = cell.run_cell(root, workload, seed=seed,
                                       seconds=0.6, trace=False,
                                       device="cpu",
                                       t_process=time.perf_counter(),
                                       base=root / "gnnbench")
    return result, numbers


def _weights_not_taken(mp):
    mp.setattr(GNNServeEngine, "reload_params", lambda self, m, p: 0)


def _half_the_neighbours(mp):
    plain = ref.fused_gnn

    def halved(blocks, h, w, *, activation="none"):
        keep = torch.zeros_like(blocks)
        keep[..., ::2] = 2.0         # every other source column, doubled
        return plain(blocks * keep, h, w, activation=activation)

    mp.setattr(ref, "fused_gnn", halved)


def _half_the_rows(mp):
    plain = Executable.step

    def step(self, batches):
        out = []
        for c, p, ms in plain(self, batches):
            half = (len(c) + 1) // 2
            out.append((np.concatenate([c[:half], c[:len(c) - half]]),
                        np.concatenate([p[:half], p[:len(p) - half]]), ms))
        return out

    mp.setattr(Executable, "step", step)


def _an_answer_altered(mp):
    plain = Executable.step

    def step(self, batches):
        out = plain(self, batches)
        c, p, ms = out[0]
        c = c.copy()
        c[0] = (c[0] + 1) % self.spec.out_dim
        return [(c, p, ms)] + out[1:]

    mp.setattr(Executable, "step", step)


CELLS = ["gcn-pubmed.refresh", "gcn-reddit01.refresh"]
FAULTS = [_weights_not_taken, _half_the_neighbours, _half_the_rows,
          _an_answer_altered]
CASES = [(w, f) for w in CELLS for f in FAULTS]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(root, workload):
    result, numbers = _run(root, workload)
    assert result["correct"], numbers
    assert numbers["compared"] > 0 and numbers["unanswered"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_a_fault_is_not_correct(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    result, numbers = _run(root, workload)
    assert not result["correct"], numbers
    assert numbers["answer_err"] > result["checks"]["answer_err"]["limit"]


def test_a_failing_engine_counts_unanswered(root, monkeypatch):
    def broken(self, batches):
        raise RuntimeError("planted")

    monkeypatch.setattr(Executable, "step", broken)
    result, numbers = _run(root, "gcn-pubmed.refresh")
    assert not result["correct"]
    assert numbers["unanswered"] > 0 and result["failed"] > 0


def test_records_hold_what_the_metrics_read(root):
    _, _, run = cell.run_cell(root, "gcn-pubmed.refresh", seed=4,
                              seconds=0.6, trace=False, device="cpu",
                              t_process=time.perf_counter(),
                              base=root / "gnnbench")
    assert run.refreshes and len(run.samples) == min(16, len(run.refreshes))
    for r in run.refreshes:
        assert run.t_open <= r.t_reload <= r.t_submit <= r.t_done
        assert r.outcome == "completed"
    assert {r.weight_set for r in run.refreshes} == {0, 1}
