"""Architecture registry of the port, with the reference's input shapes.

Every architecture of the reference's registry is here: dense, MoE, VLM
(qwen2-vl-2b: embedding inputs and M-RoPE), audio (musicgen-large: four
codebooks), hybrid (RG-LRU + local attention) and SSM. ``SHAPES`` and
``all_cells`` are the reference's assigned (arch x shape) cells;
``long_500k`` applies only to sub-quadratic archs (SSM/hybrid).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port serves {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(applicable, reason-if-not)."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch — long_500k skipped (DESIGN.md §4)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
