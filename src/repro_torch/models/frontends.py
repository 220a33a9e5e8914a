"""The modality frontends' stand-ins: precomputed patch and frame
embeddings.

Port of ``repro/models/frontends.py``.  The ``vlm`` and ``audio`` configs
run their backbone only: a VLM's first ``n_patches`` token embeddings are
replaced by patch embeddings (``transformer.forward(patch_embeds=...)``),
and the encoder-decoder encodes ``enc_seq`` frame embeddings
(``encdec.encode``).  These helpers give their shapes and synthetic values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..interop import Device, resolve_device
from .config import ModelConfig


def vision_patch_spec(cfg: ModelConfig,
                      batch: int) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) of a batch's patch embeddings."""
    return (batch, cfg.n_patches, cfg.d_model), cfg.cdtype


def audio_frame_spec(cfg: ModelConfig,
                     batch: int) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) of a batch's frame embeddings."""
    return (batch, cfg.enc_seq, cfg.d_model), cfg.cdtype


def _synth(shape: Tuple[int, ...], cfg: ModelConfig, seed: int,
           device: Optional[Device]) -> torch.Tensor:
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(cfg.cdtype)


def synth_patches(cfg: ModelConfig, batch: int, seed: int = 0,
                  device: Optional[Device] = None) -> torch.Tensor:
    """Patch embeddings (batch, n_patches, d_model) in ``cfg.cdtype``:
    normal × 0.02, drawn on ``device`` (the card unless another is named)
    from a ``torch.Generator`` seeded with ``seed``.  The distribution is
    the reference's; the numbers are not ``jax.random``'s."""
    return _synth(vision_patch_spec(cfg, batch)[0], cfg, seed, device)


def synth_frames(cfg: ModelConfig, batch: int, seed: int = 0,
                 device: Optional[Device] = None) -> torch.Tensor:
    """Frame embeddings (batch, enc_seq, d_model) in ``cfg.cdtype``, drawn
    as :func:`synth_patches` draws patches."""
    return _synth(audio_frame_spec(cfg, batch)[0], cfg, seed, device)
