"""The port's flash attention on the CPU against the JAX package.

Same inputs, made from a seed with numpy, go through
``repro.kernels.ops.flash_attention(..., interpret=True)`` (the Pallas
kernel) and ``repro.kernels.ref.attention`` on one side and
``repro_torch.kernels.ops.flash_attention`` (whose wrapper takes the plain
PyTorch version for CPU tensors) and ``repro_torch.kernels.ref.attention``
on the other.  Tolerances are ``tests/test_kernels.py``'s: 2e-5 in float32
and 2e-2 in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops, ref as jax_ref  # noqa: E402
from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as pt_flash  # noqa: E402
from repro_torch.kernels import ops as pt_ops, ref as pt_ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, H, KH, Sq, Sk, D, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, KH, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, KH, Sk, D), dtype=np.float32)
    if dtype == "bfloat16":
        q, k, v = (a.astype(jnp.bfloat16) for a in (q, k, v))
    return q, k, v


def _cpu(arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# test_kernels.py's flash shapes, with its blocks (128 x 128)
@pytest.mark.parametrize("B,H,KH,S,D", [(1, 4, 4, 256, 64),    # MHA
                                        (2, 4, 2, 256, 64),    # GQA 2:1
                                        (1, 8, 1, 512, 128)])  # MQA
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_ref(B, H, KH, S, D, causal,
                                                dtype):
    arrays = _inputs(B, H, KH, S, S, D, dtype, seed=S + H)
    jx = [jnp.asarray(a) for a in arrays]
    pallas = jax_ops.flash_attention(*jx, causal=causal, bq=128, bk=128,
                                     interpret=True)
    plain = jax_ref.attention(*jx, causal=causal)
    got = pt_ops.flash_attention(*_cpu(arrays), causal=causal)
    assert tuple(got.shape) == (B, H, S, D)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(plain), **TOL[dtype])


# Sq != Sk: the causal mask is top-left (key j visible to query i iff
# j <= i), also where Sq != Sk; test_kernels.py checks only the unmasked
# cross shape.  The second pair has ragged lengths that the TPU kernel's
# blocks divide (bq = Sq, bk = Sk).
@pytest.mark.parametrize("Sq,Sk,bq,bk", [(128, 384, 128, 128),
                                         (384, 128, 128, 128),
                                         (37, 53, 37, 53)])
@pytest.mark.parametrize("causal", [True, False])
def test_cross_shaped_and_ragged_match_pallas(Sq, Sk, bq, bk, causal):
    arrays = _inputs(1, 4, 2, Sq, Sk, 64, seed=Sq + Sk)
    jx = [jnp.asarray(a) for a in arrays]
    pallas = jax_ops.flash_attention(*jx, causal=causal, bq=bq, bk=bk,
                                     interpret=True)
    got = pt_ops.flash_attention(*_cpu(arrays), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL["float32"])


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", [(2, 6, 3, 5, 5, 32),
                                            (1, 4, 1, 12, 20, 112),
                                            (1, 2, 2, 9, 4, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_matches_the_references(B, H, KH, Sq, Sk, D, causal,
                                              dtype):
    arrays = _inputs(B, H, KH, Sq, Sk, D, dtype, seed=Sq * Sk)
    want = jax_ref.attention(*(jnp.asarray(a) for a in arrays),
                             causal=causal)
    got = pt_ref.attention(*_cpu(arrays), causal=causal)
    assert got.dtype == pt_ops.flash_attention(*_cpu(arrays)).dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_causal_rows_see_only_keys_up_to_their_index():
    """Top-left: query 0 sees key 0 alone, so its output is v[0] whatever
    Sk is; a later query sees more."""
    q, k, v = _cpu(_inputs(1, 2, 2, 3, 7, 8, seed=4))
    out = pt_ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[:, :, 0], v[:, :, 0], rtol=0, atol=1e-6)
    assert not torch.allclose(out[:, :, 1], v[:, :, 1])


def test_empty_keys_give_zeros():
    q, k, v = _cpu(_inputs(1, 2, 1, 3, 0, 8))
    out = pt_ops.flash_attention(q, k, v, causal=False)
    assert tuple(out.shape) == (1, 2, 3, 8)
    assert torch.equal(out, torch.zeros_like(out))


def test_impls_agree_and_cpu_counts_no_launch():
    q, k, v = _cpu(_inputs(2, 4, 2, 33, 33, 16, seed=5))
    before = pt_flash.flash_attention.launches
    got = pt_ops.flash_attention(q, k, v)
    want = pt_ops.flash_attention(q, k, v, impl="ref")
    assert torch.equal(got, want)
    assert pt_flash.flash_attention.launches == before
    with pytest.raises(ValueError):
        pt_ops.flash_attention(q, k, v, impl="pallas")


# (dtype, D) -> the kernel the card runs: bf16 head dims whose rows are
# 16-byte aligned (D % 8 == 0) go to the tensor cores; float32 never
@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "wgmma"),    # qwen2-7b
    (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 72, "wgmma"),     # D % 16 != 0: zero-padded to 128
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 100, "simt"),     # D % 8 != 0
    (torch.bfloat16, 1, "simt"),
    (torch.float32, 128, "simt"),
    (torch.float32, 72, "simt"),
    (torch.float32, 1, "simt")])
def test_route_follows_dtype_and_head_dim(dtype, D, want):
    assert pt_flash.route(dtype, D) == want


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 72),
                                     (torch.bfloat16, 100),
                                     (torch.float32, 128)])
def test_route_takes_misaligned_pointers_to_simt(dtype, D):
    assert pt_flash.route(dtype, D, aligned=False) == "simt"
    assert pt_flash.route(dtype, D, aligned=True) == pt_flash.route(dtype, D)


def test_cpu_bf16_launches_no_route():
    q, k, v = _cpu(_inputs(1, 28, 4, 40, 40, 128, "bfloat16", seed=6))
    assert pt_flash.route(q.dtype, 128) == "wgmma"
    before = dict(pt_flash.flash_attention.route_launches)
    got = pt_ops.flash_attention(q, k, v)
    assert torch.equal(got, pt_ref.attention(q, k, v))
    assert pt_flash.flash_attention.route_launches == before
    assert set(before) == {"wgmma", "simt"}


def test_wrapper_rejects_mismatched_inputs():
    q, k, v = _cpu(_inputs(1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        pt_flash.flash_attention(q[0], k, v)                # not 4-D
    with pytest.raises(ValueError):
        pt_flash.flash_attention(q, k, v[:, :, :4])         # k, v differ
    with pytest.raises(ValueError):
        pt_flash.flash_attention(q, k[..., :8], v[..., :8])  # D differs
    with pytest.raises(ValueError):
        q3 = _cpu(_inputs(1, 3, 2, 8, 8, 16))[0]
        pt_flash.flash_attention(q3, k, v)                  # H % KH != 0
    with pytest.raises(TypeError):
        pt_flash.flash_attention(q, k.double(), v)


# The shapes that tests/test_torch_gpu.py holds the simt kernel to on the
# card (not multiples of its 64-row query or 32-key tiles, Sq != Sk with the
# top-left mask, D from 1 to 128, GQA groups of 1, 4 and 7, grids under the
# SM count, and phase 9b's reduced qwen2-7b prefill), here through the
# wrapper's CPU path against the Pallas kernel (one block per sequence).
EDGE_SHAPES = [(1, 4, 4, 97, 161, 128, True), (1, 8, 2, 161, 97, 64, True),
               (2, 7, 1, 130, 250, 72, True), (2, 7, 1, 33, 65, 127, False),
               (3, 4, 2, 70, 70, 1, True), (1, 4, 2, 70, 70, 32, True),
               (1, 4, 2, 12, 12, 32, True), (1, 4, 1, 64, 4096, 128, False),
               (1, 8, 2, 300, 777, 128, False),
               (1, 2, 1, 1000, 1000, 128, True)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", EDGE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simt_edge_shapes_match_pallas(B, H, KH, Sq, Sk, D, causal, dtype):
    arrays = _inputs(B, H, KH, Sq, Sk, D, dtype, seed=Sq * Sk + D)
    jx = [jnp.asarray(a) for a in arrays]
    pallas = jax_ops.flash_attention(*jx, causal=causal, bq=Sq, bk=Sk,
                                     interpret=True)
    got = pt_ops.flash_attention(*_cpu(arrays), causal=causal)
    assert tuple(got.shape) == (B, H, Sq, D)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])


# chip_smoke.py's expected route of a dense path's flash launches follows
# the compute dtype and head dim through route(): qwen2-7b's bf16 prefill
# on the tensor cores, its float32 prefill on the CUDA cores
@pytest.mark.parametrize("compute_dtype,want", [("bfloat16", "wgmma"),
                                                ("float32", "simt")])
def test_chip_smoke_expected_route_follows_dtype_and_head_dim(compute_dtype,
                                                              want):
    import dataclasses
    import sys
    from pathlib import Path
    from repro_torch.configs import get_config
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = dataclasses.replace(get_config("qwen2-7b"),
                              compute_dtype=compute_dtype)
    assert cfg.head_dim == 128
    assert chip_smoke.expected_route(cfg) == want
    assert want == pt_flash.route(cfg.cdtype, cfg.head_dim, aligned=True)
    # the reduced config computes in float32, so 9b's workers run simt
    assert chip_smoke.expected_route(get_config("qwen2-7b").reduced()) == \
        "simt"
    assert chip_smoke.expected_route(get_config("falcon-mamba-7b")) is None
