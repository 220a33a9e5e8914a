"""The port's selective scan on the CPU against the JAX package.

Same inputs, made from a seed with numpy, go through
``repro.kernels.ops.ssm_scan(..., interpret=True)`` (the Pallas kernel),
``repro.kernels.ref.ssm_scan`` and ``repro.models.ssm.selective_scan`` on
one side and ``repro_torch.kernels.ops.ssm_scan`` (whose wrapper takes the
plain PyTorch version for CPU tensors) on the other.  Tolerances are
``tests/test_kernels.py``'s ssm tolerances: 1e-4 in float32 and 5e-2 in
bfloat16, where the recurrence accumulates bf16 input rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops, ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402
from repro_torch.kernels import ssm_scan as pt_scan  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _inputs(Bsz, S, D, N, dtype="float32", seed=0, h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, D), dtype=np.float32)
    dt = _softplus(rng.standard_normal((Bsz, S, D), dtype=np.float32)) * 0.1
    B = rng.standard_normal((Bsz, S, N), dtype=np.float32)
    C = rng.standard_normal((Bsz, S, N), dtype=np.float32)
    A = -_softplus(rng.standard_normal((D, N), dtype=np.float32))
    if dtype == "bfloat16":
        x, dt, B, C = (a.astype(jnp.bfloat16) for a in (x, dt, B, C))
    out = [x, dt, B, C, A]
    if h0:
        out.append(rng.standard_normal((Bsz, D, N), dtype=np.float32))
    return out


def _cpu(arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# test_kernels.py's ssm shapes
@pytest.mark.parametrize("Bsz,S,D,N", [(1, 64, 64, 8), (2, 128, 128, 16),
                                       (1, 256, 64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_matches_pallas_and_ref(Bsz, S, D, N, dtype):
    arrays = _inputs(Bsz, S, D, N, dtype)
    jx = [jnp.asarray(a) for a in arrays]
    # chunk 8 keeps interpret mode quick; test_kernels.py shows the
    # Pallas kernel does not depend on the chunk
    pallas = jax_ops.ssm_scan(*jx, chunk=8, bd=64, interpret=True)
    plain = jax_ref.ssm_scan(*jx)
    got = pt_ops.ssm_scan(*_cpu(arrays))
    assert tuple(got.shape) == (Bsz, S, D)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(plain), **TOL[dtype])


@pytest.mark.parametrize("chunk", [32, 64])   # 64 is one chunk of S
def test_ssm_scan_state_matches_selective_scan(chunk):
    x, dt, B, C, A, h0 = _inputs(2, 64, 48, 16, seed=1, h0=True)
    want_y, want_h = jax_ssm.selective_scan(
        *(jnp.asarray(a) for a in (x, dt, B, C, A, h0)), chunk)
    y, h = pt_ops.ssm_scan(*_cpu([x, dt, B, C, A]),
                           tensor_from_numpy(h0, "cpu"), return_state=True)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _f32(want_y), **TOL["float32"])
    np.testing.assert_allclose(h.numpy(), _f32(want_h), **TOL["float32"])


@pytest.mark.parametrize("S", [37, 1, 0])
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssm_scan_ragged_lengths(S, with_h0):
    arrays = _inputs(3, S, 20, 5, seed=S, h0=True)
    h0 = arrays.pop()
    h0 = h0 if with_h0 else None
    jh0 = (jnp.asarray(h0) if with_h0
           else jnp.zeros((3, 20, 5), jnp.float32))
    want_y, want_h = jax_ssm.selective_scan(
        *(jnp.asarray(a) for a in arrays), jh0, 32)
    y, h = pt_ops.ssm_scan(*_cpu(arrays),
                           None if h0 is None else tensor_from_numpy(h0, "cpu"),
                           return_state=True)
    assert tuple(y.shape) == (3, S, 20) and tuple(h.shape) == (3, 20, 5)
    np.testing.assert_allclose(y.numpy(), _f32(want_y), **TOL["float32"])
    np.testing.assert_allclose(h.numpy(), _f32(want_h), **TOL["float32"])
    if S == 0:
        np.testing.assert_array_equal(h.numpy(), _f32(jh0))


def test_impls_agree_and_cpu_counts_no_launch():
    arrays = _cpu(_inputs(2, 33, 16, 4, seed=5, h0=True))
    before = pt_scan.ssm_scan.launches
    y_k, h_k = pt_ops.ssm_scan(*arrays, return_state=True)
    y_r, h_r = pt_ops.ssm_scan(*arrays, return_state=True, impl="ref")
    assert torch.equal(y_k, y_r) and torch.equal(h_k, h_r)
    assert pt_scan.ssm_scan.launches == before
    assert not torch.equal(h_k, arrays[5])        # h0 was not overwritten
    with pytest.raises(ValueError):
        pt_ops.ssm_scan(*arrays[:5], impl="pallas")


def test_wrapper_rejects_mismatched_inputs():
    x, dt, B, C, A = _cpu(_inputs(1, 8, 16, 4))
    with pytest.raises(ValueError):
        pt_scan.ssm_scan(x, dt[:, :4], B, C, A)
    with pytest.raises(ValueError):
        pt_scan.ssm_scan(x, dt, B[..., :3], C, A)
    with pytest.raises(ValueError):
        pt_scan.ssm_scan(x, dt, B, C, A, torch.zeros(1, 16, 3))
    with pytest.raises(TypeError):
        pt_scan.ssm_scan(x, dt.double(), B, C, A)


def test_ssm_scan_wrapper_refuses_a_gradient_and_ops_differentiates_on_cpu():
    """The wrapper raises on grad-requiring inputs (before its CPU branch,
    so on the CPU too); ops.ssm_scan differentiates the plain scan on the
    CPU, and its gradient is the plain version's."""
    rng = np.random.default_rng(11)
    x, dt = (torch.from_numpy(rng.standard_normal((2, 5, 6),
                                                  dtype=np.float32))
             for _ in range(2))
    B, C = (torch.from_numpy(rng.standard_normal((2, 5, 4),
                                                 dtype=np.float32))
            for _ in range(2))
    A = -torch.rand(6, 4)
    dt = dt.abs()
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        pt_scan.ssm_scan(xg, dt, B, C, A)
    y = pt_ops.ssm_scan(xg, dt, B, C, A)
    (g,) = torch.autograd.grad(y.sum(), xg)
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        pt_ops.ssm_scan(xr, dt, B, C, A, impl="ref").sum(), xr)
    assert torch.equal(g, want)
