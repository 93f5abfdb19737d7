"""The analysis passes on the card, through the hand-written kernels.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; run them on the card with ``python -m pytest -m cuda
tests/test_torch_analyze_cuda.py``. ``tests/test_torch_analyze.py``
holds the same passes to the reference on the CPU; these hold the
probes on the card: each forward a probe drives launches exactly its
arch's kernels, the dtype pass sees no float64 outside gat's scope with
the kernels in the path, and the CLI gate passes with ``--backend
cuda``. Nothing here imports the reference package.
"""
import importlib

import pytest
import torch

from repro_torch import runtime
from repro_torch.analyze import analyze_executable, op_lint
from repro_torch.gnn.models import ARCHS, ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import _lib, csr
from torch_launches import FORWARD_LAUNCHES

FWD = importlib.import_module("repro_torch.runtime.forward")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_analyze_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cora():
    return make_dataset("cora", seed=0)


def _spec(ds, arch):
    return ZooSpec(arch, ds.profile.feature_dim, 16, ds.profile.num_classes,
                   num_layers=2, heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_probe_launches_its_forwards_kernels(cuda, cora, arch,
                                                  monkeypatch):
    exe = runtime.compile(_spec(cora, arch), cora, device=cuda,
                          backend="cuda", max_shard_n=512,
                          mutable_graph=True, analyze="error")
    forwards = []
    real = FWD.forward

    def counted(*args, **kw):
        forwards.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(FWD, "forward", counted)
    torch.cuda.synchronize()
    _lib.reset_launches()
    csr.reset_index_builds()
    rep = analyze_executable(exe, probe=True, graph=cora)
    torch.cuda.synchronize()
    assert rep.at_least("error") == [], rep.render()
    launched = {k: v for k, v in _lib.launches().items() if v}
    assert launched == {k: v * len(forwards)
                        for k, v in FORWARD_LAUNCHES[arch].items()}
    # the compiled graph's indexes were built by compile's analysis; the
    # probe's new graphs are its two mutation deltas', one index each
    assert all(v <= 2 for v in csr.index_builds().values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_dtype_pass_sees_no_float64_outside_gats_scope(cuda, cora,
                                                           arch):
    exe = runtime.compile(_spec(cora, arch), cora, device=cuda,
                          backend="cuda", max_shard_n=512)
    _lib.reset_launches()
    with torch.inference_mode():
        fs = op_lint.dtype_findings(exe._forward_fn(),
                                    (exe.params, exe._h_grouped),
                                    name=arch)
    assert fs == []
    assert sum(_lib.launches().values()) == \
        sum(FORWARD_LAUNCHES[arch].values())   # the kernels ran


@pytest.mark.cuda
def test_cuda_cli_gate_passes_with_the_kernels(cuda, capsys):
    from repro_torch.launch import analyze as cli

    assert cli.main(["--fail-on", "error", "--backend", "cuda"]) == 0
    assert "0 error" in capsys.readouterr().out
