"""Model configuration for the LM fleet (the reference's ModelConfig).

A single ModelConfig describes every family the reference supports
(dense, MoE, VLM, audio, hybrid, SSM) via a per-layer block pattern plus
optional sub-configs; the fields and defaults are the reference's, so a
config crosses between the two packages field for field. The port runs
every block kind (``models/lm.py`` raises for embedding inputs, M-RoPE
and codebooks). The configs live in ``repro_torch/configs/<arch>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

BlockKind = Literal["attn", "local_attn", "rglru", "mamba2"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    n_shared_experts: int = 0      # shared experts always applied (Qwen-MoE)
    d_ff_expert: int = 0           # routed expert hidden dim
    d_ff_shared: int = 0           # per-shared-expert hidden dim
    capacity_factor: float = 1.25
    router_softmax_topk: bool = True  # softmax over selected experts' logits


@dataclasses.dataclass(frozen=True)
class SSMConfig:               # Mamba2 / SSD
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:             # RecurrentGemma / Griffin
    lru_width: int = 0         # 0 -> d_model
    conv_width: int = 4
    c_exponent: float = 8.0    # a_t = exp(c * r_t * log_a)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    block_pattern: tuple[str, ...] = ()     # empty -> all "attn"
    mlp_kind: str = "swiglu"                # swiglu | geglu | gelu | none
    moe: MoEConfig | None = None
    moe_layer_step: int = 1                 # every k-th layer is MoE
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    rope_kind: str = "rope"                 # rope | mrope
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    local_window: int | None = None         # for local_attn layers
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale: float = 1.0                  # MiniCPM scale_emb
    residual_scale: float = 1.0             # MiniCPM scale_depth / sqrt(L)
    logit_scale: float = 1.0                # MiniCPM d_model/dim_model_base etc.
    n_codebooks: int = 1                    # MusicGen EnCodec codebooks
    input_mode: str = "tokens"              # tokens | embeddings (VLM stub)
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # the reference's kv-chunk cap for its unrolled attention loop; kept
    # for field parity (the port's prefill attention is one kernel)
    attn_chunk_max: int = 8
    sub_quadratic: bool = False             # eligible for long_500k

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern:
            if len(self.block_pattern) != self.n_layers:
                raise ValueError(f"block_pattern has {len(self.block_pattern)} "
                                 f"entries for {self.n_layers} layers")
            return self.block_pattern
        return ("attn",) * self.n_layers

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_layer_step == self.moe_layer_step - 1)

    def num_params(self) -> int:
        """Analytic parameter count (total)."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab_size * d * self.n_codebooks
        if not self.tie_embeddings:
            total += self.vocab_size * d * self.n_codebooks
        for i, kind in enumerate(self.pattern):
            total += d  # pre-norm scale
            if kind in ("attn", "local_attn"):
                total += d * self.n_heads * dh  # wq
                total += 2 * d * self.n_kv_heads * dh  # wk, wv
                total += self.n_heads * dh * d  # wo
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * dh
                if self.qk_norm:
                    total += 2 * dh
            elif kind == "mamba2":
                ssm = self.ssm
                d_in = ssm.expand * d
                nheads = d_in // ssm.head_dim
                conv_ch = d_in + 2 * ssm.n_groups * ssm.d_state
                total += d * (2 * d_in + 2 * ssm.n_groups * ssm.d_state + nheads)
                total += conv_ch * ssm.d_conv
                total += 3 * nheads  # A_log, D, dt_bias
                total += d_in  # gated norm
                total += d_in * d  # out_proj
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * self.rglru.conv_width
                total += 2 * w * w + 2 * w  # gates a/x + biases
                total += w  # log-lambda
                total += w * d  # out proj
            if self._layer_has_mlp(i):
                total += d  # post-norm scale
                if self.is_moe_layer(i):
                    m = self.moe
                    total += d * m.num_experts  # router
                    total += m.num_experts * 3 * d * m.d_ff_expert
                    total += m.n_shared_experts * 3 * d * m.d_ff_shared
                else:
                    mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    total += mult * d * self.d_ff
        total += d  # final norm
        return total

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only the routed top-k)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.is_moe_layer(i))
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model \
            * m.d_ff_expert
        return self.num_params() - n_moe_layers * inactive

    def _layer_has_mlp(self, i: int) -> bool:
        if self.mlp_kind == "none":
            return False
        return self.pattern[i] != "mamba2"
