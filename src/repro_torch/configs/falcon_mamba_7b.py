"""falcon-mamba-7b [ssm] — attention-free Mamba1.
64L d_model=4096 ssm_state=16 vocab=65024 (d_inner = 2×4096 = 8192).
[arXiv:2410.05355; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free); keeps config uniform
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,               # mamba blocks have no separate FFN
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
)
