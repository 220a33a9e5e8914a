"""zamba2-7b [hybrid] — Mamba2 backbone + SHARED full transformer block
applied every 6 layers (one parameter set reused at 13 sites).
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    shared_attn_every=6,
    rope_theta=10_000.0,
)
