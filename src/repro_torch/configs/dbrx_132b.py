"""dbrx-132b [moe] — 16 experts top-4 (fine-grained), GQA 48H/8kv.
40L d_model=6144 d_ff(expert)=10752 vocab=100352. [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    capacity_factor=1.25,
    moe_group=4096,
    rope_theta=500_000.0,
)
