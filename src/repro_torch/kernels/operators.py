"""The kernels as ``torch.library`` operators, with fake implementations and
the FLOPs each one does.

``repro_torch::matmul``, ``repro_torch::flash_attention`` (with the rows'
log-sum-exp it keeps for training, when asked),
``repro_torch::flash_attention_backward``, ``repro_torch::ssm_scan`` (with
the states it keeps for training, when asked) and
``repro_torch::ssm_scan_backward`` call the kernels' wrappers
(looked up in their modules at each call), so on the card they launch the
kernels and count the launches as the wrappers always do, and for CPU
tensors they give the plain versions.  Their fake implementations give the
outputs' shapes and dtypes without running anything: what a count over
fake tensors needs, where a wrapper cannot run (it reads ``data_ptr()``,
and a ctypes launch needs memory).

``kernels/ops.py`` (and the autograd Functions' forward and backward) call
an operator only when this module is loaded and a count is running
(:data:`counting`, set by ``launch.costs.Counter``), or when an argument
is a fake tensor; every other call goes to the wrapper directly, so a
process that counts nothing never loads ``torch.library`` machinery or
this module (``tests/test_torch_isolation.py``).

:data:`FLOPS` maps each operator to ``fn(args, out) -> (flops, dtype)``:
the work its kernel does and the type of its arithmetic, which
``launch.costs`` prices at that type's peak.  The byte count of every
operator is the generic one (each input read once, each output written
once).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from . import flash_attention as _flash
from . import matmul as _matmul
from . import ref
from . import ssm_scan as _scan

Tensor = torch.Tensor

#: counts running in this process (``launch.costs.Counter`` adds one while
#: it counts); while it is above 0, ``ops.py`` routes through the operators
counting = 0


def matmul_flops(M: int, N: int, K: int) -> int:
    """``2 M N K``: a multiply and an add per term of each output."""
    return 2 * M * N * K


def flash_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs a head attends: under the top-left causal
    mask query ``i`` sees ``min(i + 1, Sk)`` keys, else all ``Sk``."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def flash_flops(B: int, H: int, Sq: int, Sk: int, D: int,
                causal: bool) -> int:
    """``4 D`` operations per visible pair and head: ``q·k`` and ``p v``,
    a multiply and an add per element each.  The softmax's exp, max and
    sums are not counted, as the TPU kernel's cost estimate leaves them
    out."""
    return 4 * D * flash_pairs(Sq, Sk, causal) * B * H


def flash_backward_flops(B: int, H: int, Sq: int, Sk: int, D: int,
                         causal: bool) -> int:
    """``14 D`` operations per visible pair and head: the seven products
    the backward kernels do, ``2 D`` each: the dK/dV pass's ``Sᵀ = K Qᵀ``,
    ``dPᵀ = V dOᵀ``, ``dV += Pᵀ dO`` and ``dK += dSᵀ Q``, and the dQ pass's
    ``S``, ``dP`` (both recomputed) and ``dQ += dS K``.  The least work
    is five products, ``10 D`` (``launch.costs.flash_backward_bound``).
    The exponentials, ``dS = P ∘ (dP − Δ)`` and the pre-pass's ``Δ =
    rowsum(dO ∘ O)`` (``2 D`` a row) are not counted, as
    :func:`flash_flops` leaves the softmax out."""
    return 14 * D * flash_pairs(Sq, Sk, causal) * B * H


def scan_flops(Bsz: int, S: int, D: int, N: int) -> int:
    """7 float32 operations per state element and step: ``dt·A``, its
    exp (counted as one), ``dt·x``, its product with ``B``, the decay of
    ``h``, the add, and the product with ``C`` (its sum over ``N`` folded
    into that one)."""
    return 7 * Bsz * S * D * N


def scan_backward_flops(Bsz: int, S: int, D: int, N: int) -> int:
    """20 float32 operations per state element and step: the recomputed
    forward's 7 and the backward's 13 (``g``'s update, the four products
    of ``dC``, ``dB``, ``dx`` and ``ddt``, ``dA``'s)."""
    return 20 * Bsz * S * D * N


def _dtype(t: Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def matmul(x: Tensor, y: Tensor) -> Tensor:
    return _matmul.matmul(x, y)


@matmul.register_fake
def _(x, y):
    return x.new_empty((x.shape[0], y.shape[1]))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    keep_lse: bool) -> Tuple[Tensor, Tensor]:
    """``(out, lse)``; ``lse`` is empty unless ``keep_lse``."""
    if keep_lse:
        return _flash.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    return (_flash.flash_attention(q, k, v, causal=causal),
            q.new_empty((0,), dtype=torch.float32))


@flash_attention.register_fake
def _(q, k, v, causal, keep_lse):
    B, H, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (B, H, Sq) if keep_lse else (0,), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                             dout: Tensor, lse: Tensor, causal: bool
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(_flash.flash_attention_backward(q, k, v, out, dout, lse,
                                                 causal=causal))


@flash_attention_backward.register_fake
def _(q, k, v, out, dout, lse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def ssm_scan(x: Tensor, dt: Tensor, B: Tensor, C: Tensor, A: Tensor,
             h0: Optional[Tensor], keep_states: bool
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(y, h_final, states)``; ``states`` is empty unless
    ``keep_states`` (an operator returns tensors only)."""
    if keep_states:
        y, h, states = _scan.ssm_scan(x, dt, B, C, A, h0,
                                      return_states=True)
    else:
        y, h = _scan.ssm_scan(x, dt, B, C, A, h0, return_state=True)
        states = x.new_empty((0,), dtype=torch.float32)
    return y, (h.clone() if h is h0 else h), states


@ssm_scan.register_fake
def _(x, dt, B, C, A, h0, keep_states):
    Bsz, S, D = x.shape
    N = A.shape[1]
    states = (x.new_empty((Bsz, -(-S // ref.STATE_CHUNK), D, N),
                          dtype=torch.float32)
              if keep_states else x.new_empty((0,), dtype=torch.float32))
    return (torch.empty_like(x),
            x.new_empty((Bsz, D, N), dtype=torch.float32), states)


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=())
def ssm_scan_backward(x: Tensor, dt: Tensor, B: Tensor, C: Tensor,
                      A: Tensor, h0: Optional[Tensor], dy: Tensor,
                      dh_final: Optional[Tensor], states: Optional[Tensor]
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                 Tensor]:
    return tuple(_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh_final,
                                         states=states))


@ssm_scan_backward.register_fake
def _(x, dt, B, C, A, h0, dy, dh_final, states):
    Bsz, S, D = x.shape
    f32 = torch.float32
    return (torch.empty_like(x, dtype=f32), torch.empty_like(x, dtype=f32),
            torch.empty_like(B, dtype=f32), torch.empty_like(C, dtype=f32),
            torch.empty_like(A, dtype=f32),
            x.new_empty((Bsz, D, A.shape[1]), dtype=f32))


def _matmul_cost(args, out) -> Tuple[int, str]:
    x, y = args[:2]
    return matmul_flops(x.shape[0], y.shape[1], x.shape[1]), _dtype(x)


def _flash_cost(args, out) -> Tuple[int, str]:
    q, k = args[:2]
    causal = args[3]
    B, H, Sq, D = q.shape
    return flash_flops(B, H, Sq, k.shape[2], D, causal), _dtype(q)


def _flash_backward_cost(args, out) -> Tuple[int, str]:
    q, k = args[:2]
    causal = args[6]
    B, H, Sq, D = q.shape
    return (flash_backward_flops(B, H, Sq, k.shape[2], D, causal),
            _dtype(q))


def _scan_cost(args, out) -> Tuple[int, str]:
    x, A = args[0], args[4]
    Bsz, S, D = x.shape
    return scan_flops(Bsz, S, D, A.shape[1]), "float32"


def _scan_backward_cost(args, out) -> Tuple[int, str]:
    x, A = args[0], args[4]
    Bsz, S, D = x.shape
    return scan_backward_flops(Bsz, S, D, A.shape[1]), "float32"


#: each operator's (FLOPs, dtype of its arithmetic) from its arguments
FLOPS: Dict[object, Callable] = {
    torch.ops.repro_torch.matmul.default: _matmul_cost,
    torch.ops.repro_torch.flash_attention.default: _flash_cost,
    torch.ops.repro_torch.flash_attention_backward.default:
        _flash_backward_cost,
    torch.ops.repro_torch.ssm_scan.default: _scan_cost,
    torch.ops.repro_torch.ssm_scan_backward.default: _scan_backward_cost,
}
