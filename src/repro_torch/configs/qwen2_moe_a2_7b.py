"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (kv=16) routed d_ff=1408,
vocab=151936, 60 routed experts top-4 + 4 shared experts (4×1408).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, n_shared_experts=4,
                  d_ff_expert=1408, d_ff_shared=1408,
                  router_softmax_topk=True),
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=48,
    vocab_size=256,
    qkv_bias=True,
    moe=MoEConfig(num_experts=6, top_k=2, n_shared_experts=2,
                  d_ff_expert=48, d_ff_shared=48,
                  router_softmax_topk=True),
    param_dtype="float32",
    compute_dtype="float32",
)
