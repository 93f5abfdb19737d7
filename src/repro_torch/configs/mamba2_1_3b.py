"""mamba2-1.3b [ssm] — 48L d=2048, attention-free (SSD mixer only, no MLP),
vocab=50280, d_state=128, expand=2 → d_inner=4096, 64 heads × head_dim 64.
[arXiv:2405.21060; unverified]

Sub-quadratic: eligible for long_500k (state is O(1) in sequence length).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # attention unused
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("mamba2",) * 48,
    mlp_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    block_pattern=("mamba2",) * 2,
    mlp_kind="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                  n_groups=1, chunk_size=8),
    tie_embeddings=True,
    sub_quadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
)
