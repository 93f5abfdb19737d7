"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 (GeGLU), vocab=256000; RG-LRU + local attention (window 2048) in
the Griffin 2:1 pattern (rec, rec, attn). [arXiv:2402.19427; hf]

Sub-quadratic: eligible for long_500k (local attention window bounds the
KV cache at 2048; RG-LRU state is O(1)).
"""
import math

from repro_torch.models.config import ModelConfig, RGLRUConfig

_PATTERN = tuple(("rglru", "rglru", "local_attn")[i % 3] for i in range(26))

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=_PATTERN,
    mlp_kind="geglu",
    local_window=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    emb_scale=math.sqrt(2560),
    tie_embeddings=True,
    rope_theta=10_000.0,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    mlp_kind="geglu",
    local_window=16,
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
    emb_scale=8.0,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sub_quadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
)
