"""The port stands alone: no JAX, no reference package, no quiet CPU.

An AST scan of every module of ``src/repro_torch``, of ``chip_smoke.py``
and of the torch examples (``examples/torch_*.py``) fails on any import
of ``jax``, ``jaxlib``, ``repro`` or ``repro.*`` (``repro_torch`` itself
is fine). And an entry point that was not asked
for the CPU must raise on a machine without CUDA rather than run there.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_scan_covers_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "forward.py", "registry.py", "serve.py",
            "lm.py", "attention.py", "flash_attention.py", "engine.py",
            "qwen3_8b.py", "torch_quickstart.py", "torch_serve_gnn.py",
            "torch_dataflow_explorer.py", "torch_serve_lm.py",
            "torch_train_lm.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_flags_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import sharding\n"
           "import repro_torch\nfrom repro_torch.kernels import ref\n")
    mods = list(_imported_modules(ast.parse(src)))
    assert [m for m in mods if _forbidden(m)] == ["jax.numpy", "repro.core"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_compile_without_device_raises_without_cuda(no_cuda):
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec

    edges = np.array([[0, 1], [1, 0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.compile(ZooSpec("gcn", 4, 4, 2), (edges, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.compile(ZooSpec("gcn", 4, 4, 2), (edges, 2), device="cuda")
    exe = runtime.compile(ZooSpec("gcn", 4, 4, 2),
                          (edges, 2, np.ones((2, 4), np.float32)),
                          device="cpu")
    assert exe.forward().shape == (2, 2)


def test_engine_without_device_raises_without_cuda(no_cuda):
    from repro_torch.serving import GNNServeEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        GNNServeEngine()
    assert GNNServeEngine(device="cpu").device.type == "cpu"


def test_lm_engine_without_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine

    cfg = get_smoke("qwen3-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"
