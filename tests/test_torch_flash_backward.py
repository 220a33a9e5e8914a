"""The flash attention gradient's plain versions on the CPU against the JAX
package, and the backward's route.

The forward keeps each row's log-sum-exp for the backward
(``repro_torch.kernels.ref.attention(..., return_lse=True)``, which the
wrapper returns for CPU tensors); it is held to ``jax.nn.logsumexp`` of the
masked float32 logits of ``repro.kernels.ref.attention``.  The plain
backward (``flash_attention.attention_backward``, which
``flash_attention_backward`` runs for CPU tensors), given that lse as the
backward kernels consume it, is held to ``jax.grad`` of the reference's
attention.  The same inputs, made from a seed with numpy, go to both.
Tolerances are the forward's (``tests/test_kernels.py``): 2e-5 in float32
and 2e-2 in bfloat16, of each gradient's largest entry.  The kernels
themselves run on the card: ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as pt_flash  # noqa: E402
from repro_torch.kernels import ops as pt_ops, ref as pt_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, KH, Sq, Sk, D): MHA, GQA, MQA, Sq < Sk and Sq > Sk, D = 72 and
# 112 (the wgmma route's head dims that are no multiple of 16 or 64), and
# no keys at all
SHAPES = [(1, 4, 4, 33, 33, 16), (2, 6, 2, 40, 40, 32),
          (1, 4, 1, 17, 29, 8), (1, 8, 2, 29, 17, 64),
          (1, 4, 2, 20, 24, 72), (1, 2, 1, 16, 16, 112),
          (1, 2, 1, 5, 0, 16)]


def _inputs(B, H, KH, Sq, Sk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D),
                            (B, H, Sq, D))]
    if dtype == "bfloat16":
        arrays = [a.astype(jnp.bfloat16) for a in arrays]
    return arrays


def _cpu(arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _jax_logits(q, k, causal):
    """``repro.kernels.ref.attention``'s masked float32 logits."""
    H, Sq, D = q.shape[1:]
    KH, Sk = k.shape[1:3]
    k = jnp.repeat(jnp.asarray(k), H // KH, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q).astype(jnp.float32),
                   k.astype(jnp.float32)) * (D ** -0.5)
    if causal:
        s = jnp.where(jnp.arange(Sk)[None, :] <= jnp.arange(Sq)[:, None], s,
                      -1e30)
    return s


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_lse_matches_jax_logsumexp(B, H, KH, Sq, Sk, D, causal,
                                                 dtype):
    q, k, v, _ = _inputs(B, H, KH, Sq, Sk, D, dtype, seed=Sq * 7 + Sk)
    want = np.asarray(jax.nn.logsumexp(_jax_logits(q, k, causal), axis=-1))
    out, lse = pt_ref.attention(*_cpu((q, k, v)), causal=causal,
                                return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Sq)
    got = lse.numpy()
    if Sk == 0:
        assert np.all(got == -np.inf) and np.all(want == -np.inf)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the wrapper gives the plain version's pair for CPU tensors
    w_out, w_lse = pt_flash.flash_attention(*_cpu((q, k, v)), causal=causal,
                                            return_lse=True)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_given_lse_matches_jax_grad(B, H, KH, Sq, Sk, D,
                                                   causal, dtype):
    q, k, v, dout = _inputs(B, H, KH, Sq, Sk, D, dtype, seed=Sq + Sk + D)

    def loss(q, k, v):
        out = jax_ref.attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * dout.astype(np.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    tq, tk, tv, tdout = _cpu((q, k, v, dout))
    out, lse = pt_ref.attention(tq, tk, tv, causal=causal, return_lse=True)
    before = dict(pt_flash.flash_attention_backward.route_launches)
    got = pt_flash.flash_attention_backward(tq, tk, tv, out, tdout, lse,
                                            causal=causal)
    assert pt_flash.flash_attention_backward.route_launches == before
    plain = pt_flash.attention_backward(tq, tk, tv, out, tdout,
                                        causal=causal, lse=lse)
    tol = TOL[dtype]
    for name, g, p, w in zip("qkv", got, plain, want):
        assert torch.equal(g, p), name
        assert g.dtype == tq.dtype and tuple(g.shape) == np.shape(w)
        scale = np.abs(_f32(w)).max() if np.size(w) else 0.0
        if scale == 0.0:                     # Sk = 0: nothing to attend
            assert not np.any(_f32(g)), name
            continue
        err = np.abs(_f32(g) - _f32(w)).max() / scale
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype,D,aligned,want", [
    (torch.bfloat16, 128, True, "wgmma"), (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 72, True, "wgmma"), (torch.bfloat16, 112, True, "wgmma"),
    (torch.bfloat16, 20, True, "simt"), (torch.bfloat16, 1, True, "simt"),
    (torch.bfloat16, 128, False, "simt"), (torch.float32, 128, True, "simt"),
    (torch.float32, 72, False, "simt")])
def test_backward_route_follows_dtype_head_dim_and_alignment(dtype, D,
                                                             aligned, want):
    """The backward takes the forward's route, with out and dout among the
    tensors that must be 16-byte aligned for the wgmma kernel's TMA."""
    assert pt_flash.route(dtype, D, aligned=aligned) == want
    assert set(pt_flash._BWD_ENTRY) == set(pt_flash._ENTRY)


def test_the_function_backward_takes_the_forwards_lse(monkeypatch):
    """On the CPU, FlashAttention saves the forward's lse and hands it to
    flash_attention_backward (the plain backward for CPU tensors), once a
    backward; nothing launches."""
    calls = []
    inner = pt_flash.flash_attention_backward

    def recording(q, k, v, out, dout, lse, *, causal):
        calls.append((tuple(lse.shape), lse.dtype, causal))
        return inner(q, k, v, out, dout, lse, causal=causal)
    monkeypatch.setattr(pt_flash, "flash_attention_backward", recording)
    q, k, v, dout = _cpu(_inputs(1, 4, 2, 9, 9, 16, "float32", seed=3))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = pt_ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, dout)
    assert calls == [((1, 4, 9), torch.float32, True)]
    want = torch.autograd.grad(pt_ref.attention(*leaves, causal=True),
                               leaves, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_backward_wrapper_rejects_mismatched_inputs():
    q, k, v, dout = _cpu(_inputs(1, 4, 2, 8, 8, 16, "float32", seed=1))
    out, lse = pt_ref.attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        pt_flash.flash_attention_backward(q, k, v, out, dout, lse[:, :2],
                                          causal=True)
    with pytest.raises(ValueError, match="lse"):
        pt_flash.flash_attention_backward(q, k, v, out, dout, lse.double(),
                                          causal=True)
    with pytest.raises(ValueError, match="shaped as q"):
        pt_flash.flash_attention_backward(q, k, v, out[:, :, :4], dout, lse,
                                          causal=True)
    with pytest.raises(TypeError):
        pt_flash.flash_attention_backward(q, k, v, out, dout.bfloat16(),
                                          lse, causal=True)


# TRAIN_GRAD_SHAPES of chip_smoke.py: 11c's and llava's training attention,
# the ragged row, whisper's encoder, cross-attention and decoder
BOUND_SHAPES = [(2, 28, 4, 2048, 2048, 128, True),
                (2, 56, 8, 2048, 2048, 128, True),
                (2, 8, 2, 1000, 1000, 64, True),
                (16, 6, 6, 1500, 1500, 64, False),
                (16, 6, 6, 448, 1500, 64, False),
                (16, 6, 6, 448, 448, 64, True)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", BOUND_SHAPES)
@pytest.mark.parametrize("dtype,itemsize", [("float32", 4), ("bfloat16", 2)])
def test_backward_bound_is_within_the_lse_of_forward_and_backward(
        B, H, KH, Sq, Sk, D, causal, dtype, itemsize):
    """The backward alone moves q, out, dout, dq and k, v, dk, dv once and
    the float32 lse: the bound of forward and backward (q, k, v, dout read;
    out, dq, dk, dv written; no lse) plus the lse's bytes at most, and the
    backward's five products are 10/14 of the pair's 14 D operations."""
    from repro_torch.launch import costs
    both, _ = costs.flash_bound(B, H, KH, Sq, Sk, D, causal, dtype, itemsize,
                                backward=True)
    alone, by = costs.flash_backward_bound(B, H, KH, Sq, Sk, D, causal,
                                           dtype, itemsize)
    lse_ms = 4 * B * H * Sq / costs.HBM_BYTES_PER_S * 1e3
    assert alone <= both + lse_ms * (1 + 1e-9)
    nbytes = itemsize * 4 * (B * H * Sq * D + B * KH * Sk * D) + 4 * B * H * Sq
    ops = 2.5 * costs.operators.flash_flops(B, H, Sq, Sk, D, causal)
    want = max(nbytes / costs.HBM_BYTES_PER_S,
               ops / costs.PEAK_FLOPS[dtype]) * 1e3
    assert alone == pytest.approx(want, rel=1e-12)
    assert by == ("bytes" if nbytes / costs.HBM_BYTES_PER_S
                  > ops / costs.PEAK_FLOPS[dtype] else "operations")


# --------------------------------------------------------------------------
# the backward kernels' unit list (kernels/flash_attention.py::
# backward_schedule): what one launch of each kernel runs, heaviest first
# --------------------------------------------------------------------------

# (B, H, KH, Sq, Sk, causal): 11c's and llava's training attention, the
# ragged row, whisper's encoder (not causal) and cross-attention (Sq < Sk),
# Sq > Sk both ways, keys past every query, one query, and granite-20b's
# training attention (MQA: 48 query heads over one kv head)
SCHEDULE_SHAPES = [(2, 28, 4, 2048, 2048, True), (2, 56, 8, 2048, 2048, True),
                   (2, 8, 2, 1000, 1000, True), (16, 6, 6, 1500, 1500, False),
                   (16, 6, 6, 448, 1500, False), (1, 4, 2, 300, 77, True),
                   (1, 4, 1, 65, 300, True), (2, 7, 1, 1, 129, True),
                   (1, 2, 2, 200, 77, False), (2, 48, 1, 2048, 2048, True)]


def _walked_steps(B, H, KH, Sq, Sk, causal, rows):
    """Each unit's steps, counted from the mask itself: a dK/dV unit walks
    every (query head of its group, 64-row query tile) in which some query
    sees one of its keys, a dQ unit every 64-key tile of which some key is
    seen by one of its queries (all of them when not causal)."""
    G, step = H // KH, pt_flash.BWD_STEP
    want = {}
    for b in range(B):
        for g in range(KH):
            for t in range(-(-Sk // rows)):
                first_key = t * rows
                tiles = sum(1 for qt in range(-(-Sq // step))
                            if not causal
                            or min(step * qt + step, Sq) - 1 >= first_key)
                want[pt_flash.DKDV, t, g, b] = G * tiles
        for h in range(H):
            for t in range(-(-Sq // rows)):
                last_query = min(rows * t + rows, Sq) - 1
                want[pt_flash.DQ, t, h, b] = sum(
                    1 for kt in range(-(-Sk // step))
                    if not causal or step * kt <= last_query)
    return want


@pytest.mark.parametrize("B,H,KH,Sq,Sk,causal", SCHEDULE_SHAPES)
@pytest.mark.parametrize("rows", [128, 64])
def test_backward_schedule_lists_every_unit_once_heaviest_first(
        B, H, KH, Sq, Sk, causal, rows):
    """Every (kind, tile, head, batch) of a shape exactly once, each with
    the cost of the steps its kernel walks (4 products a dK/dV step, 3 a
    dQ step), in non-increasing cost; a unit with no step is listed too,
    since it writes zeros."""
    units = pt_flash.backward_schedule(B, H, KH, Sq, Sk, causal, rows)
    steps = _walked_steps(B, H, KH, Sq, Sk, causal, rows)
    got = {u[:4]: u[4] for u in units}
    assert len(got) == len(units) == len(steps)
    assert got == {key: pt_flash.BWD_STEP_COST[key[0]] * n
                   for key, n in steps.items()}
    costs = [u[4] for u in units]
    assert costs == sorted(costs, reverse=True)
    assert units == pt_flash.backward_schedule(B, H, KH, Sq, Sk, causal,
                                               rows)


def _greedy_makespan(costs, sms=132):
    """List scheduling: each unit, in list order, to the SM that frees
    first (one block an SM)."""
    import heapq
    free = [0] * sms
    for c in costs:
        heapq.heappush(free, heapq.heappop(free) + c)
    return max(free)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,causal", SCHEDULE_SHAPES[:2])
@pytest.mark.parametrize("rows", [128, 64])
def test_backward_schedule_reaches_near_the_ideal_makespan(B, H, KH, Sq, Sk,
                                                           causal, rows):
    """At 11c's and llava's shapes, the list taken greedily by 132 SMs ends
    within 1.12 x the ideal (the products spread evenly over the SMs), and
    below the two launches of the earlier design (the dK/dV blocks in grid
    order, then the dQ blocks heaviest first)."""
    units = pt_flash.backward_schedule(B, H, KH, Sq, Sk, causal, rows)
    costs = [u[4] for u in units]
    ideal = sum(costs) / 132
    got = _greedy_makespan(costs)
    assert got <= 1.12 * ideal, (got, ideal)
    kv = [u for u in units if u[0] == pt_flash.DKDV]
    grid_order = sorted(kv, key=lambda u: (u[3], u[2], u[1]))
    two_launches = (_greedy_makespan([u[4] for u in grid_order])
                    + _greedy_makespan([u[4] for u in units
                                        if u[0] == pt_flash.DQ]))
    assert got < two_launches


def test_backward_units_are_cached_per_shape_and_device():
    """The kernels' int32 (n, 4) list is made once per shape and device
    and handed out again, so a step copies nothing to the card; another
    shape (a rank's local heads) or device has its own."""
    shape = (1, 4, 2, 100, 77, True, 64)
    units = pt_flash.backward_units(*shape, torch.device("cpu"))
    assert units.dtype == torch.int32 and units.device.type == "cpu"
    assert units.tolist() == [list(u[:4]) for u in
                              pt_flash.backward_schedule(*shape)]
    assert pt_flash.backward_units(*shape, "cpu") is units
    local = pt_flash.backward_units(1, 2, 1, 100, 77, True, 64, "cpu")
    assert local is not units and local.shape[0] < units.shape[0]
    other = pt_flash.backward_units(*shape, torch.device("meta"))
    assert other is not units and other.device.type == "meta"
    assert pt_flash.backward_units(*shape, "meta") is other
    assert pt_flash.backward_units(1, 4, 2, 100, 77, False, 64,
                                   "cpu") is not units
