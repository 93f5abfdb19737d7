"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792,
vocab=256000, no bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

Note: the real Cohere model uses parallel attention+FFN blocks and
LayerNorm; we use the framework's sequential pre-RMSNorm blocks, as the
reference package does (a deviation — it does not change parameter or
FLOP counts materially).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=256,
    rope_theta=75_000_000.0,
    param_dtype="float32",
    compute_dtype="float32",
)
