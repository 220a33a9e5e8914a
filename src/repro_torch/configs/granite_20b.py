"""granite-20b [dense] — code model, MQA (kv=1).
52L d_model=6144 48H d_ff=24576 vocab=49152. [arXiv:2405.04324; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_act="gelu",        # gpt-bigcode lineage: 2-matrix GeLU MLP
    rope_theta=10_000.0,
)
