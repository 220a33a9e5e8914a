"""The port's own kernels as the device trace names them, and the least
time each could take on the card: the larger of the operations its
algorithm needs over the peak rate and the bytes of its inputs read once
and outputs written once over the memory bandwidth.

What a kernel reads or computes again (the flash backward's recomputed
scores, the scan's states kept for the backward) is not counted: a
redesign that drops such work shows as a higher share, never as less work.
"""
from __future__ import annotations

import re
from typing import Dict, NamedTuple, Tuple

from . import peaks
from .flops import visible_pairs


class Kernel(NamedTuple):
    """One of the port's kernels: the launch counter that
    ``repro_torch.kernels.launch_counts()`` keeps for its wrapper, and the
    device kernels one launch of the wrapper runs, each once."""
    counter: str
    records: Tuple[str, ...]        # regular expressions over trace names


PORT_KERNELS = {
    "flash_fwd": Kernel("flash_attention",
                        (r"\bflash_wgmma_kernel\b|\bflash_attention_kernel\b",)),
    "flash_bwd": Kernel("flash_attention_backward",
                        (r"\bflash_bwd_kernel\b", r"\bdelta_kernel\b")),
    "scan_fwd": Kernel("ssm_scan", (r"\bssm_scan_kernel\b",)),
    "scan_bwd": Kernel("ssm_scan_backward",
                       (r"\bssm_scan_bwd_kernel\b",
                        r"\bssm_scan_bwd_sum_kernel\b")),
    "matmul": Kernel("matmul", (r"\bmatmul_wgmma_kernel\b|\bmatmul_kernel\b",)),
}

_ANY = re.compile("|".join(p for k in PORT_KERNELS.values()
                           for p in k.records))


def is_port_kernel(name: str) -> bool:
    return _ANY.search(name) is not None


def matches_one(pattern: str, name: str) -> bool:
    return re.search(pattern, name) is not None


def matches(kernel: str, name: str) -> bool:
    """Whether the trace name ``name`` is one of ``kernel``'s records."""
    return any(matches_one(p, name) for p in PORT_KERNELS[kernel].records)


def bound_s(flops: float, flop_rate: float, nbytes: float) -> float:
    return max(flops / flop_rate, nbytes / peaks.HBM_BYTES)


def flash_fwd(B: int, H: int, KH: int, S: int, D: int, elem: int = 2,
              causal: bool = True) -> Dict[str, float]:
    """Causal self-attention forward of q (B, H, S, D) over k, v (B, KH, S,
    D) in ``elem``-byte elements: 4 · D FLOPs per visible pair per head
    (Q Kᵀ and P V); q, k, v read and out written once, the float32 row
    log-sum-exp written once."""
    flops = 4.0 * D * visible_pairs(S, causal) * B * H
    nbytes = elem * (2 * B * H * S * D + 2 * B * KH * S * D) + 4 * B * H * S
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, peaks.BF16_FLOPS, nbytes)}


def flash_bwd(B: int, H: int, KH: int, S: int, D: int, elem: int = 2,
              causal: bool = True) -> Dict[str, float]:
    """Its backward: 10 · D FLOPs per visible pair per head (dV = Pᵀ dO,
    dP = dO Vᵀ, dQ = dS K, dK = dSᵀ Q, and Q Kᵀ once to form P); q, k, v,
    out, dout and the lse read once, dq, dk, dv written once."""
    flops = 10.0 * D * visible_pairs(S, causal) * B * H
    nbytes = (elem * (3 * B * H * S * D + 2 * B * KH * S * D)    # q, out, dout, k, v
              + 4 * B * H * S                                    # lse
              + elem * (B * H * S * D + 2 * B * KH * S * D))     # dq, dk, dv
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, peaks.BF16_FLOPS, nbytes)}


# float32 operations a (batch, step, channel, state) element needs: the
# forward's decay exp(dt · A) (2), h = a · h + (dt · x) · B (3) and its
# share of y = Σ C · h (2); the backward's dh and the five input gradients
SCAN_FWD_OPS = 7
SCAN_BWD_OPS = 14


def scan_fwd(B: int, S: int, D: int, N: int) -> Dict[str, float]:
    """The selective scan's forward, float32: x and dt (B, S, D), B and C
    (B, S, N) and A (D, N) read once, y (B, S, D) and the final state (B,
    D, N) written once."""
    flops = float(SCAN_FWD_OPS * B * S * D * N)
    nbytes = 4 * (2 * B * S * D + 2 * B * S * N + D * N
                  + B * S * D + B * D * N)
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, peaks.F32_FLOPS, nbytes)}


def scan_bwd(B: int, S: int, D: int, N: int) -> Dict[str, float]:
    """Its backward: x, dt, B, C, A and dy read once (the final state's
    gradient, zeros in training, not counted), dx, ddt, dB, dC and dA
    written once."""
    flops = float(SCAN_BWD_OPS * B * S * D * N)
    nbytes = 4 * ((3 * B * S * D + 2 * B * S * N + D * N)       # read
                  + (2 * B * S * D + 2 * B * S * N + D * N))    # written
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, peaks.F32_FLOPS, nbytes)}
