"""The autotuner on the card (``cuda`` marker; skips without a card).

Run on the card with ``python -m pytest -m cuda
tests/test_torch_tune_cuda.py``. gcn is tuned at a small scale through
the hand-written kernels: the winner's key names the card, no candidate
fails, and the winner's logits equal an analytic compile's bitwise when
both run the same program (the same ``executed_digest``), else within
1e-4, and within 1e-4 of the ``reference`` backend. Nothing here imports
the JAX package: the card's machine has no JAX.
"""
import json

import pytest
import torch

from repro_torch import runtime
from repro_torch.analyze import plan_lint
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_tune_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tune_gcn_names_the_card(cuda, tmp_path):
    runtime.clear_tune_cache()
    ds = make_dataset("cora", seed=0, scale=0.5)
    spec = ZooSpec("gcn", ds.profile.feature_dim, 16,
                   ds.profile.num_classes)
    store = runtime.GraphStore()
    kw = dict(device=cuda, max_shard_n=256, store=store, seed=0)
    tuned = runtime.compile(spec, ds, plan="autotune", tune_budget=8,
                            plan_cache_dir=tmp_path, **kw)
    rep = tuned.tune_report
    assert tuned.plan_source == "autotune"
    assert rep["candidates_failed"] == 0 and rep["candidates_measured"] >= 1
    (path,) = tmp_path.glob("tune-*.json")
    scope = json.loads(path.read_text())["scope"]
    assert scope["device"] == torch.cuda.get_device_name(cuda)
    assert scope["backend"] == "cuda"

    analytic = runtime.compile(spec, ds, **kw)
    got, want = tuned.forward(), analytic.forward()
    if plan_lint.executed_digest(tuned.plan) == \
            plan_lint.executed_digest(analytic.plan):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)
    ref = runtime.compile(spec, ds, backend="reference", **kw).forward()
    torch.testing.assert_close(got, ref, **TOL)
    assert torch.isfinite(got).all()

