"""qwen2-7b [dense] — GQA 28H/4kv with QKV bias.
28L d_model=3584 d_ff=18944 vocab=152064. [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
