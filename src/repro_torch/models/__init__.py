"""The port's language models (``repro/models/`` in the reference).

Ported so far: the configuration (``config.py``), the shared layers
(``layers.py``: norms, embeddings, RoPE, attention with a KV cache, the
MLP), Mamba1 and Mamba2 (SSD) (``ssm.py``) and the stacked decoder-only LM
for plan kinds ``attn`` without experts, ``mamba1``, ``mamba2`` and the
zamba2 hybrid ``mamba2_shared`` (``transformer.py``: serving, and training
with the loss, remat and gradients).  MoE and encoder-decoder come with a
later slice (ROADMAP §1 item 7).
"""
