"""The port's language models (``repro/models/`` in the reference).

Ported so far: the configuration (``config.py``), the shared layers the
Mamba1 path needs (``layers.py``), Mamba1 (``ssm.py``) and the stacked
decoder-only LM for plan kind ``mamba1`` (``transformer.py``).  Attention,
RoPE, the MLP, MoE, Mamba2 and encoder-decoder come with later slices
(ROADMAP §1 items 5 and 6).
"""
