"""The port's selective scan on the CPU against the JAX package.

Same inputs, made from a seed with numpy, go through
``repro.kernels.ops.ssm_scan(..., interpret=True)`` (the Pallas kernel),
``repro.kernels.ref.ssm_scan`` and ``repro.models.ssm.selective_scan`` on
one side and ``repro_torch.kernels.ops.ssm_scan`` (whose wrapper takes the
plain PyTorch version for CPU tensors) on the other.  Tolerances are
``tests/test_kernels.py``'s ssm tolerances: 1e-4 in float32 and 5e-2 in
bfloat16, where the recurrence accumulates bf16 input rounding.

Gradients: the hand-derived plain backward (``ref.ssm_scan_backward``)
against autograd of the plain scan within ``GRAD_TOL`` = 1e-5 of each
gradient's largest entry (float32 on both sides, differing in summation
order and in where the chunked recompute rounds; measured under 3e-7), and
the ``SSMScan`` Function against ``jax.grad`` of the reference's
``selective_scan`` within 1e-4 of the largest entry, the scan tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops, ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402
from repro_torch.kernels import ssm_scan as pt_scan  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
GRAD_TOL = 1e-5
GRADS = ("dx", "ddt", "dB", "dC", "dA", "dh0")


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
    # the Function's backward is the hand-derived plain version, not
    # autograd of the loop: equal up to float32 summation order
    assert _rel_err(g, want) <= GRAD_TOL


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (0 for empty)."""
    if want.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _grad_inputs(Bsz, S, D, N, seed, with_h0, with_dh):
    """Scan inputs as the model makes them, upstream gradients dy and (with
    ``with_dh``) dh_final, all float32 CPU tensors; h0 and dh_final are
    None unless asked for."""
    x, dt, B, C, A, h0 = _inputs(Bsz, S, D, N, seed=seed, h0=True)
    rng = np.random.default_rng(seed + 1000)
    dy = rng.standard_normal((Bsz, S, D), dtype=np.float32)
    dh = rng.standard_normal((Bsz, D, N), dtype=np.float32)
    return (x, dt, B, C, A, h0 if with_h0 else None, dy,
            dh if with_dh else None)


def _autograd_of_plain(x, dt, B, C, A, h0, dy, dh):
    """(dx, ddt, dB, dC, dA, dh0) by autograd of ref.ssm_scan; zeros for an
    input the output does not reach (S = 0), dh0 = a_0 g_0 also without h0
    (the gradient to a zero initial state)."""
    from repro_torch.kernels import ref
    ins = [t.clone().requires_grad_() for t in _cpu([x, dt, B, C, A])]
    state = torch.from_numpy(h0 if h0 is not None
                             else np.zeros((x.shape[0], A.shape[0],
                                            A.shape[1]), np.float32))
    state.requires_grad_()
    y, h = ref.ssm_scan(*ins, state, return_state=True)
    loss = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    if not loss.requires_grad:              # S = 0 and no dh_final
        return [torch.zeros_like(t) for t in ins + [state]]
    grads = torch.autograd.grad(loss, ins + [state], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins + [state])]


# ref.SCAN_CHUNK is 64: S <= 64 recomputes h in one chunk; 65, 130 and
# 200 cross one, two and three chunk boundaries, 200 raggedly
@pytest.mark.parametrize("S", [0, 1, 37, 64, 65, 130, 200])
@pytest.mark.parametrize("N", [1, 16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dh", [False, True])
def test_plain_backward_matches_autograd_of_the_plain_scan(S, N, with_h0,
                                                           with_dh):
    from repro_torch.kernels import ref
    assert ref.SCAN_CHUNK == 64
    arrays = _grad_inputs(2, S, 6, N, seed=S + N, with_h0=with_h0,
                          with_dh=with_dh)
    want = _autograd_of_plain(*arrays)
    got = ref.ssm_scan_backward(
        *(None if a is None else torch.from_numpy(a) for a in arrays))
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) <= GRAD_TOL, (name, _rel_err(g, w))
    if S == 0:        # the final state is h0: its gradient passes through
        dh = arrays[7]
        assert torch.equal(got[5], torch.zeros_like(got[5]) if dh is None
                           else torch.from_numpy(dh))


# ref.STATE_CHUNK is 16: S = 16 and 64 end on a boundary, 17, 37 and 130
# one step or more past one
@pytest.mark.parametrize("S", [0, 1, 16, 17, 37, 64, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_scan_states_are_the_state_at_each_chunk_boundary(S, with_h0):
    """``ref.ssm_scan(..., return_states=True)`` keeps the state before every
    STATE_CHUNK steps: each equals the final state of the scan stopped
    there, bit for bit; y and h_final are those of the plain call."""
    from repro_torch.kernels import ref
    assert ref.STATE_CHUNK == 16
    x, dt, B, C, A, h0 = _cpu(_inputs(2, S, 12, 5, seed=S + 7, h0=True))
    h0 = h0 if with_h0 else None
    y, h, states = ref.ssm_scan(x, dt, B, C, A, h0, return_states=True)
    assert states.shape == (2, -(-S // 16), 12, 5)
    assert states.dtype == torch.float32
    want_y, want_h = ref.ssm_scan(x, dt, B, C, A, h0, return_state=True)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    for k in range(states.shape[1]):
        t = 16 * k
        _, at = ref.ssm_scan(x[:, :t], dt[:, :t], B[:, :t], C[:, :t], A, h0,
                             return_state=True)
        assert torch.equal(states[:, k], at), k


@pytest.mark.parametrize("S", [0, 1, 37, 64, 65, 130])
@pytest.mark.parametrize("with_states", [False, True])
def test_plain_backward_given_states_equals_the_result_without(S,
                                                               with_states):
    """``ref.ssm_scan_backward`` starts its chunks from the forward's states
    when it is given them, and gives the same bits as when it makes them
    itself; the wrapper on the CPU passes them through and checks their
    shape."""
    from repro_torch.kernels import ref
    x, dt, B, C, A, h0, dy, dh = (
        None if a is None else torch.from_numpy(a)
        for a in _grad_inputs(2, S, 6, 16, seed=S, with_h0=with_states,
                              with_dh=with_states))
    states = ref.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
    want = ref.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh)
    got = ref.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh, states=states)
    wrapped = pt_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh,
                                        states=states)
    for name, g, k, w in zip(GRADS, got, wrapped, want):
        assert torch.equal(g, w) and torch.equal(k, w), name
    with pytest.raises(ValueError, match="states"):
        pt_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh,
                                  states=states[:, :0] if S else
                                  torch.zeros(2, 1, 6, 16))


@pytest.mark.parametrize("S,chunk", [(64, 32), (100, 32), (1, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_function_gradient_matches_jax_grad_of_selective_scan(S, chunk,
                                                              with_h0):
    """The SSMScan Function on the CPU (the wrapper's plain forward, the
    plain backward) against jax.grad of the reference's chunked scan.  S =
    100 is a multiple of neither the reference's chunk (which then scans
    in one chunk) nor the plain backward's recompute chunk of 64."""
    x, dt, B, C, A, h0, dy, dh = _grad_inputs(2, S, 24, 16, seed=S,
                                              with_h0=True, with_dh=True)
    if not with_h0:
        h0 = np.zeros_like(h0)

    def loss(xs, dts, Bc, Cc, Am, h0s):
        y, h = jax_ssm.selective_scan(xs, dts, Bc, Cc, Am, h0s, chunk)
        return (y * dy).sum() + (h * dh).sum()

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x, dt, B, C, A, h0)))
    ins = [t.requires_grad_() for t in _cpu([x, dt, B, C, A])]
    state = (tensor_from_numpy(h0, "cpu").requires_grad_() if with_h0
             else None)
    y, h = pt_scan.SSMScan.apply(*ins, state)
    assert type(y.grad_fn).__name__ == "SSMScanBackward"
    loss_pt = (y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(loss_pt, ins + ([state] if with_h0 else []))
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL["float32"]["rtol"], (name, err)


def test_function_casts_gradients_back_to_bf16_inputs():
    x, dt, B, C, A, h0, dy, _ = _grad_inputs(1, 20, 8, 4, seed=3,
                                             with_h0=True, with_dh=False)
    bf = [tensor_from_numpy(a, "cpu").to(torch.bfloat16).requires_grad_()
          for a in (x, dt, B, C)]
    Ag = tensor_from_numpy(A, "cpu").requires_grad_()
    y = pt_ops.ssm_scan(*bf, Ag, tensor_from_numpy(h0, "cpu"))
    assert y.dtype == torch.bfloat16
    got = torch.autograd.grad(y.float().mul(torch.from_numpy(dy)).sum(),
                              bf + [Ag])
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32]
    f32 = [t.detach().float() for t in bf]
    want = pt_ops.ssm_scan(*f32, torch.from_numpy(A),
                           torch.from_numpy(h0), return_state=True)
    assert want[0].dtype == torch.float32
    # y is bf16, so the gradient that reaches it is dy rounded to bf16
    plain = pt_scan.ssm_scan_backward(
        *f32, torch.from_numpy(A), torch.from_numpy(h0),
        torch.from_numpy(dy).to(torch.bfloat16).float())
    for g, w in zip(got, plain):
        assert torch.equal(g, w.to(g.dtype))


def test_backward_wrapper_checks_its_inputs_and_counts_no_cpu_launch():
    x, dt, B, C, A, h0, dy, dh = _cpu(_grad_inputs(2, 9, 5, 3, seed=4,
                                                   with_h0=True,
                                                   with_dh=True))
    before = pt_scan.ssm_scan_backward.launches
    got = pt_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh)
    from repro_torch.kernels import launch_counts, ref
    want = ref.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert pt_scan.ssm_scan_backward.launches == before
    assert launch_counts()["ssm_scan_backward"] == before
    with pytest.raises(ValueError, match="dy"):
        pt_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy[:, :4], dh)
    with pytest.raises(ValueError, match="dh_final"):
        pt_scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh[..., :2])
    with pytest.raises(ValueError):
        pt_scan.ssm_scan_backward(x, dt[:, :4], B, C, A, h0, dy, dh)


def test_reduced_mamba_trains_on_the_cpu_with_checkpoint_and_resume(
        tmp_path):
    """``launch/train.py --arch falcon-mamba-7b --reduced --device cpu``: 8
    steps with a checkpoint every 5, an uninterrupted run to 12 and a run
    resumed from step 5 that replays its steps 6..11 (rtol 1e-4); the
    gradient goes through SSMScan, and no kernel launches on the CPU."""
    from repro_torch.launch import train
    calls = []
    backward = pt_scan.SSMScan.backward

    def counted(ctx, *grads):
        calls.append(1)
        return backward(ctx, *grads)
    before = (pt_scan.ssm_scan.launches, pt_scan.ssm_scan_backward.launches)
    base = ["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "5",
            "--log-every", "100"]
    pt_scan.SSMScan.backward = staticmethod(counted)
    try:
        r1 = train.main(base + ["--ckpt-dir", str(tmp_path / "ck"),
                                "--steps", "8"])
        r_full = train.main(base + ["--ckpt-dir", str(tmp_path / "ref"),
                                    "--steps", "12"])
        r2 = train.main(base + ["--ckpt-dir", str(tmp_path / "ck"),
                                "--steps", "12", "--resume"])
    finally:
        pt_scan.SSMScan.backward = staticmethod(backward)
    assert np.isfinite(r_full["losses"]).all()
    np.testing.assert_allclose(r1["losses"], r_full["losses"][:8],
                               rtol=1e-4, atol=1e-5)
    assert r2["start_step"] == 6
    np.testing.assert_allclose(r2["losses"], r_full["losses"][6:12],
                               rtol=1e-4, atol=1e-5)
    layers = 4                                   # the reduced config's
    assert len(calls) == layers * (8 + 12 + 6)
    assert (pt_scan.ssm_scan.launches,
            pt_scan.ssm_scan_backward.launches) == before
