"""Architecture registry of the port.

The dense, MoE, hybrid (RG-LRU + local attention) and SSM LMs are
ported; the reference registry's VLM and audio architectures raise
``NotImplementedError`` (ROADMAP.md, Queue 1 items 7.5 and 7.6).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}
# the reference's architectures that are not ported yet, with their item
UNPORTED = {"qwen2-vl-2b": "7.5 (M-RoPE and embedding inputs)",
            "musicgen-large": "7.6 (codebooks)"}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port serves {ARCHS} "
            f"(ROADMAP.md, Queue 1 item {UNPORTED[arch]})")
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port serves {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
