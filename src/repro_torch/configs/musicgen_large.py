"""musicgen-large [audio] — 48L d=2048 32H (MHA kv=32, head_dim 64)
d_ff=8192, vocab=2048, decoder-only over 4 EnCodec codebooks (delay
pattern handled by the data pipeline; the backbone sums 4 codebook
embeddings and emits 4 parallel heads). [arXiv:2306.05284; hf]

The EnCodec audio frontend is a STUB per the assignment; text conditioning
(cross-attention in the original) is out of backbone scope and noted in
DESIGN.md.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    mlp_kind="gelu",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    n_codebooks=4,
    mlp_kind="gelu",
    rope_theta=10_000.0,
    param_dtype="float32",
    compute_dtype="float32",
)
