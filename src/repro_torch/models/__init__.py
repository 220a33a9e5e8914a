"""The port's language models (``repro/models/`` in the reference).

Ported so far: the configuration (``config.py``), the shared layers
(``layers.py``: norms, embeddings, RoPE, attention with a KV cache, the
MLP), Mamba1 (``ssm.py``) and the stacked decoder-only LM for plan kinds
``attn`` without experts and ``mamba1`` (``transformer.py``: serving, and
training with the loss, remat and gradients).  MoE, Mamba2
and encoder-decoder come with a later slice (ROADMAP §1 item 7).
"""
