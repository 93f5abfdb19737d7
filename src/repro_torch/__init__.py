"""GNNerator on PyTorch and CUDA (one NVIDIA Hopper card).

The package mirrors ``repro``'s layout module for module, so each file
here has one obvious counterpart there. It imports ``torch`` and numpy
only. The device work of the main path — single-device GNN inference
through :func:`repro_torch.runtime.compile` — runs in four CUDA C++
kernels under ``kernels/csrc``; every kernel keeps a plain PyTorch
version beside it (``kernels/ref.py``) that CPU tensors use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
