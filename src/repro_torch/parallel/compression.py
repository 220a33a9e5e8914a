"""Gradient compression with error feedback.

Port of ``repro/parallel/compression.py`` (:23-93).  Used on the ``pod``
axis where the all-reduce crosses the slow link of a multi-pod mesh: int8
block-quantized all-reduce cuts the payload 4× against float32 (2× against
bf16) at negligible quality cost when error feedback carries the
quantization residual to the next step (Seide et al.; 1-bit Adam lineage).

``quantize`` gives the reference's codes and scales bit for bit on the same
float32 input, on the CPU and on the card: both divide in float32 and round
half to even (``torch.round`` as ``jnp.round``).  Every division here is by
a tensor on the operand's device (:func:`_div`): dividing a CUDA tensor by
a Python number multiplies by its float32 reciprocal, which is one ulp off
the quotient for some inputs.  The compressor is stateless across
calls except for the residual tree the caller threads through the train
step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_map
from .collectives import pmax, psum


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as the reference's division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Int8BlockCompressor:
    """Symmetric per-block int8 quantization; blocks of ``block`` elements
    of the flattened tensor."""
    block: int = 256

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.float().reshape(-1)
        return F.pad(flat, (0, (-flat.numel()) % self.block)).reshape(
            -1, self.block)

    def quantize(self, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int8 codes (n_blocks, block), float32 scales (n_blocks, 1))."""
        blocks = self._blocks(x)
        scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
        scale = scale.clamp_min(1e-12)
        q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
        return q, scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor,
                   shape: Tuple[int, ...]) -> torch.Tensor:
        flat = (q.float() * scale).reshape(-1)
        return flat[:math.prod(shape)].reshape(shape)

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        q, s = self.quantize(x)
        return self.dequantize(q, s, tuple(x.shape))

    def all_reduce(self, x: torch.Tensor, mesh,
                   axes: Sequence[str]) -> torch.Tensor:
        """Quantize, all-reduce int32 accumulators, dequantize, mean over
        ``axes`` of ``mesh``.

        The scale is all-reduced with max and every rank requantizes
        against that global scale, so summing the int8 values in int32
        keeps the reduction exact.
        """
        _, scale = self.quantize(x)
        for ax in axes:
            scale = pmax(scale, mesh, ax)
        q = torch.round(self._blocks(x) / scale).clamp(-127, 127).to(
            torch.int32)
        n = 1
        for ax in axes:
            q = psum(q, mesh, ax)
            n *= mesh.shape[ax]
        return _div(self.dequantize(q.float(), scale, tuple(x.shape)), n)


def compress_with_feedback(grads: Any, residual: Any,
                           comp: Int8BlockCompressor) -> Tuple[Any, Any]:
    """Error-feedback wrapper: g' = Q(g + r); r' = (g + r) - g'."""
    def one(g, r):
        total = g.float() + r
        approx = comp.roundtrip(total)
        return approx, total - approx
    out = tree_map(one, grads, residual)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(dtype_bytes: int = 4) -> float:
    """Bytes of the compressed payload (int8 codes and a float32 scale a
    block of 256) against the uncompressed tensor's."""
    return (1 + 4 / 256) / dtype_bytes
