"""llava-next-34b [vlm] — backbone only (anyres tiling frontend is a STUB:
``input_specs`` feeds precomputed patch embeddings).
60L d_model=7168 56H/8kv d_ff=20480 vocab=64000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    n_patches=576,          # one base-resolution tile; anyres adds more
    rope_theta=5_000_000.0,
)
