"""llama4-scout-17b-a16e [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1 + 1 shared expert, every layer.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Llama-4 routes with sigmoid scores (router_softmax_topk=False). The
"16E top-1 + shared" structure gives 17B active of ~109B total.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=16, top_k=1, n_shared_experts=1,
                  d_ff_expert=8192, d_ff_shared=8192,
                  router_softmax_topk=False),
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=1, n_shared_experts=1,
                  d_ff_expert=96, d_ff_shared=96,
                  router_softmax_topk=False),
    rope_theta=500_000.0,
    param_dtype="float32",
    compute_dtype="float32",
)
