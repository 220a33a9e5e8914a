"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + one shared expert.
48L d_model=5120 40H/8kv d_ff(expert)=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Training this arch uses Adafactor (see launch/train.py): Adam's 2×f32 state
on 400B params (3.2 TB) cannot fit a single v5e-256 pod alongside weights.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    moe_every=2,            # interleaved: every other layer is MoE
    n_shared_experts=1,
    capacity_factor=1.25,
    moe_group=4096,
    param_dtype="bfloat16",
    rope_theta=500_000.0,
)
