"""qwen3-14b [dense] — GQA 40H/8kv + per-head RMS qk_norm.
40L d_model=5120 d_ff=17408 vocab=151936. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
