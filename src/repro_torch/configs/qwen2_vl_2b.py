"""qwen2-vl-2b [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960, vocab=151936,
M-RoPE (sections 16/24/24 over head_dim/2), dynamic resolution.
[arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B,S,D) plus (3,B,S) M-RoPE position ids
(t/h/w); the backbone transformer is fully implemented.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    input_mode="embeddings",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(2, 3, 3),
    input_mode="embeddings",
    param_dtype="float32",
    compute_dtype="float32",
)
