"""The port's language models (``repro/models/`` in the reference).

Ported so far: the configuration (``config.py``), the shared layers
(``layers.py``: norms, embeddings, RoPE, attention with a KV cache, the
MLP), Mamba1 and Mamba2 (SSD) (``ssm.py``), the MoE layer (``moe.py``) and
the stacked decoder-only LM for plan kinds ``attn`` (dense, MoE, and MoE
interleaved with dense layers), ``mamba1``, ``mamba2`` and the zamba2
hybrid ``mamba2_shared`` (``transformer.py``: serving, and training with
the loss, remat and gradients), the encoder-decoder (``encdec.py``:
whisper's backbone, trained, prefilled and decoded) and the modality
frontends' stand-ins (``frontends.py``: patch and frame embeddings).
"""


def model_module(cfg):
    """The model module that builds ``cfg``: ``encdec`` for an
    encoder-decoder config, else ``transformer``, as the reference's
    ``launch/steps.py:100`` picks it."""
    if cfg.is_encoder_decoder:
        from . import encdec
        return encdec
    from . import transformer
    return transformer
