"""minicpm-2b [dense] — 40L d=2304 36H (MHA kv=36, head_dim 64) d_ff=5760,
vocab=122753, tied embeddings, μP-style scaling (scale_emb=12,
scale_depth=1.4 → residual×1.4/√L, logits×1/(d/dim_model_base=256)) and a
WSD LR schedule (implemented in training/optimizer.py).
[arXiv:2404.06395; hf]
"""
import math

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    emb_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=1.0 / (2304 / 256),
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    emb_scale=12.0,
    residual_scale=1.4 / math.sqrt(2),
    logit_scale=0.25,
    rope_theta=10_000.0,
    param_dtype="float32",
    compute_dtype="float32",
)
