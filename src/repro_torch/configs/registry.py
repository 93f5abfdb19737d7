"""Architecture registry of the port.

Only the dense attention LMs are ported; every other architecture of the
reference registry raises ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port serves {ARCHS} "
            f"(ROADMAP.md, Queue 1 item 7)")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
