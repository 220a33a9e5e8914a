"""The port's int8 gradient compression against the JAX package's, every
case of ``tests/test_compression.py``, and the codes bit for bit.

Inputs are numpy draws from a seed handed to both packages.  ``quantize``
gives the reference's int8 codes and float32 scales bit for bit (both
divide in float32 and round half to even), so ``roundtrip`` and the error
feedback's residuals are equal too; the properties the reference asserts
(error bounds, zeros, the time-average under feedback, the wire ratio)
are asserted of the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.parallel import compression as JC  # noqa: E402
from repro_torch.parallel import compression as PC  # noqa: E402


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("shape", [(1000,), (33, 5), (3, 7, 129)])
def test_quantize_is_the_references_bit_for_bit(block, shape):
    """A length that is not a multiple of the block pads the last one."""
    x = _normal(7, shape, 5.0)
    jq, js = JC.Int8BlockCompressor(block).quantize(jnp.asarray(x))
    q, s = PC.Int8BlockCompressor(block).quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    got = PC.Int8BlockCompressor(block).roundtrip(torch.from_numpy(x))
    want = JC.Int8BlockCompressor(block).roundtrip(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roundtrip_error_bounded_by_scale():
    comp = PC.Int8BlockCompressor(block=256)
    x = torch.from_numpy(_normal(0, (1000,), 5.0))
    out = comp.roundtrip(x)
    # per-block max-abs / 127 is the quantization step; error <= step/2 + eps
    err = (out - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_roundtrip_within_half_each_blocks_step():
    """Round to nearest against each block's own scale: every block within
    half its step (a few ulp over for the float32 quotient and product), on
    blocks whose magnitudes differ by 1e4, where a truncating quantizer or
    one leaf-wide scale would be off by up to a whole step."""
    comp = PC.Int8BlockCompressor(block=64)
    mags = np.repeat(np.float32(10.0) ** np.arange(-2, 3, dtype=np.float32),
                     64)[:300]
    x = torch.from_numpy(_normal(3, (300,)) * mags)
    _, step = comp.quantize(x)
    err = (comp._blocks(comp.roundtrip(x)) - comp._blocks(x)).abs().amax(
        dim=1, keepdim=True)
    assert bool((err <= step * (0.5 * (1 + 2 ** -14))).all())
    assert float((err / step).max()) > 0.4


@pytest.mark.parametrize("shape", [(7,), (33, 5), (4, 4, 4)])
def test_roundtrip_preserves_shape_and_zeros(shape):
    comp = PC.Int8BlockCompressor(block=64)
    out = comp.roundtrip(torch.zeros(shape))
    assert tuple(out.shape) == shape
    assert torch.equal(out, torch.zeros(shape))


def test_error_feedback_mean_converges():
    """With error feedback, the time-average of compressed grads converges
    to the time-average of true grads (residual stays bounded), and each
    step's output and residual are the reference's."""
    comp = PC.Int8BlockCompressor(block=256)
    jcomp = JC.Int8BlockCompressor(block=256)
    w = _normal(0, (512,), 0.01)
    g, jg = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    res, jres = PC.init_residual(g), JC.init_residual(jg)
    total_true = torch.zeros(512)
    total_comp = torch.zeros(512)
    for _ in range(50):
        approx, res = PC.compress_with_feedback(g, res, comp)
        japprox, jres = JC.compress_with_feedback(jg, jres, jcomp)
        np.testing.assert_array_equal(approx["w"].numpy(),
                                      np.asarray(japprox["w"]))
        np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jres["w"]))
        total_true += g["w"]
        total_comp += approx["w"]
    # cumulative compressed sum differs from true sum by at most the residual
    np.testing.assert_allclose((total_comp + res["w"]).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-4)
    assert float(res["w"].abs().max()) < 0.01   # bounded residual


def test_compression_ratio():
    assert PC.compression_ratio(4) == JC.compression_ratio(4) < 0.26
    assert PC.compression_ratio(2) == JC.compression_ratio(2) < 0.52
