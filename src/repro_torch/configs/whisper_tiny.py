"""whisper-tiny [audio] — encoder-decoder; conv frontend is a STUB
(``input_specs`` feeds precomputed frame embeddings at enc_seq=1500).
4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    is_encoder_decoder=True,
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    enc_seq=1500,
    frontend="audio",
    mlp_act="gelu",
    norm_type="layernorm",
    use_rope=False,
    qkv_bias=True,
    tie_embeddings=True,
)
