"""The port's data plane (``repro_torch/cluster/serde.py``) for torch
tensors, against the reference's serde (``repro/cluster/serde.py``) on the
same numpy data.

Torch pickles a tensor's storage in-band, so the port reduces every strided
tensor to a pickle-5 out-of-band buffer of its host bytes: a 4 MiB tensor
must leave the stream small and cross as one buffer, as a numpy array does
in the reference, and every dtype (bf16 included) must arrive bit for bit
over the ``shm`` and ``sock`` transports.
"""
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import serde as rserde                        # noqa: E402
from repro_torch.cluster import serde                            # noqa: E402
from repro_torch.interop import tensor_from_numpy, tensor_to_numpy  # noqa: E402

DTYPES = ["float32", "bfloat16", "int64"]


def _sample(dtype: str, shape=(300, 257), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        return rng.integers(-2**62, 2**62, shape, dtype=np.int64)
    a = rng.standard_normal(shape, dtype=np.float32) * 1e3
    if dtype == "bfloat16":
        import ml_dtypes
        return a.astype(ml_dtypes.bfloat16)
    return a


def _bits(t: torch.Tensor) -> np.ndarray:
    return tensor_to_numpy(t).reshape(-1).view(np.uint8)


def _roundtrip_sock(value):
    """Publish ``value`` in a unix-socket peer server's store and pull it
    back the way a consumer worker does (``transport="sock"``)."""
    d = tempfile.mkdtemp(prefix="rrpeer")
    server = serde.PeerServer(os.path.join(d, "w0.sock"), {7: value})
    try:
        return serde.peer_fetch(serde.PeerRef(server.path, 7, 0, 0))
    finally:
        server.close()
        serde.sweep_peer_sockets(d)


@pytest.mark.parametrize("transport", ["shm", "sock"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensors_roundtrip_bit_for_bit(dtype, transport):
    a = _sample(dtype)
    t = tensor_from_numpy(a, "cpu")
    value = {"t": t, "view": t[::3, 5:40], "scalar": t[2, 2].clone()}
    if transport == "shm":
        enc = serde.encode(value, transport="shm", threshold=1024)
        assert enc.shm_refs(), "the body should go through shared memory"
        try:
            copied = serde.decode(enc)
            mapped = serde.decode(enc, serde.SegmentKeeper())
        finally:
            serde.release(enc)
        outs = [copied, mapped]
    else:
        outs = [_roundtrip_sock(value)]
    for got in outs:
        for k, want in value.items():
            assert got[k].dtype == want.dtype and got[k].shape == want.shape
            assert np.array_equal(_bits(got[k]), _bits(want)), k
    # the same data through the reference's serde, as numpy
    ref = rserde.decode(rserde.encode(a, transport="shm", threshold=1024))
    assert np.array_equal(_bits(outs[0]["t"]), ref.reshape(-1).view(np.uint8))


def test_a_4_mib_tensor_crosses_out_of_band_like_a_numpy_array():
    t = torch.randn(1024, 1024)                      # 4 MiB of float32
    raw = []
    stream = serde.dumps(t, buffer_callback=raw.append)
    assert len(raw) >= 1 and sum(b.raw().nbytes for b in raw) == 4 << 20
    assert len(stream) < 1024
    # what torch's own reduction and the reference's numpy path give
    plain = []
    assert len(pickle.dumps(t, protocol=5, buffer_callback=plain.append)) \
        > 4 << 20 and not plain
    nraw = []
    assert len(pickle.dumps(t.numpy(), protocol=5,
                            buffer_callback=nraw.append)) < 1024
    assert len(nraw) == 1
    enc = serde.encode(t, transport="shm")
    try:
        assert isinstance(enc.data, bytes) and len(enc.data) < 1024
        assert [r.nbytes for r in enc.shm_refs()] == [4 << 20]
        assert enc.pipe_nbytes() < 1024
        assert enc.direct_nbytes() == 4 << 20
    finally:
        serde.release(enc)


def test_payload_size_of_a_tensor_is_its_bytes():
    """The size each ``done`` reports for locality-aware placement."""
    t = torch.zeros(300, 257, dtype=torch.bfloat16)
    assert serde.payload_nbytes(t) == 300 * 257 * 2
    assert serde.payload_nbytes({"a": t, "b": [t]}) == \
        64 + 1 + 1 + 64 + 2 * 300 * 257 * 2


def test_a_mapped_tensor_outlives_its_segment_name():
    """Zero-copy decode views the mapping, which the keeper pins: the
    driver may unlink the segment while the tensor is alive."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    enc = serde.encode(t, transport="shm", threshold=1024)
    keeper = serde.SegmentKeeper()
    got = serde.decode(enc, keeper)
    serde.release(enc)                               # unlink the name
    assert torch.equal(got, t) and float(got.sum()) == float(t.sum())
    got += 1                                         # writable
    with pytest.raises(serde.TransferLost):
        serde.decode(enc)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(0, 3),
    lambda: torch.tensor(3.5),
    lambda: torch.tensor([True, False, True]),
    lambda: torch.randn(4, 6).t(),                    # not contiguous
    lambda: torch.randn(5, dtype=torch.complex64).conj(),
    lambda: torch.arange(10, dtype=torch.int16).flip(0)._neg_view(),
])
def test_edge_tensors_roundtrip(make):
    t = make()
    got = serde.decode(serde.encode(t, transport="driver"))
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t.resolve_conj().resolve_neg())
    assert not got.is_conj()


def test_sparse_tensors_keep_torchs_reduction():
    t = torch.eye(4).to_sparse()
    got = serde.decode(serde.encode(t, transport="driver"))
    assert got.is_sparse and torch.equal(got.to_dense(), t.to_dense())


def test_a_tensor_rebuilds_on_the_device_it_names():
    """The reducer records the device; rebuilding copies there.  (A CUDA
    tensor's own round trip is in ``tests/test_torch_gpu.py``.)"""
    fn, (buf, dtype, shape, device) = serde._reduce_tensor(torch.ones(2, 3))
    assert (dtype, shape, device) == ("float32", (2, 3), "cpu")
    out = fn(bytes(buf.raw()), dtype, shape, "meta")
    assert out.device.type == "meta" and out.shape == (2, 3)
