"""Optimizers and learning-rate schedules (``repro/optim/`` in the
reference)."""
from .optimizers import (AdamW, Adafactor, SGD, clip_by_global_norm,
                         global_norm)
from .schedules import cosine_schedule, linear_warmup

__all__ = ["AdamW", "Adafactor", "SGD", "clip_by_global_norm",
           "global_norm", "cosine_schedule", "linear_warmup"]
