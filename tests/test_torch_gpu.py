"""The port's CUDA kernel and main path on the card.

Marked ``gpu``: each test skips inside itself when no CUDA device is
present.  On the card run ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Kernel tolerance: ``tests/test_kernels.py``'s matmul tolerances (2e-5
float32, 2e-2 bfloat16) applied to ``out / sqrt(K)``, against the plain
version with TF32 off.
"""
import math

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (1000, 1531, 777),
                                   (1, 129, 7), (257, 3, 1), (64, 64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, M, N, K, dtype):
    from repro_torch.kernels import matmul as mm, ref
    g = torch.Generator(device=cuda).manual_seed(M * 7 + N * 3 + K)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    y = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    before = mm.matmul.launches
    got = mm.matmul(x, y)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    assert got.shape == (M, N) and got.dtype == dtype
    s = math.sqrt(max(K, 1))
    want = ref.matmul(x, y)
    assert torch.allclose(got.float() / s, want.float() / s,
                          rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_is_deterministic_across_launches(cuda):
    from repro_torch.kernels import matmul as mm
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(777, 1024, generator=g, device=cuda)
    y = torch.randn(1024, 333, generator=g, device=cuda)
    first = mm.matmul(x, y)
    for _ in range(3):
        assert torch.equal(mm.matmul(x, y).view(torch.int32),
                           first.view(torch.int32))


def test_launch_counter_loses_no_update_under_threads(cuda):
    import sys
    import threading
    from repro_torch.kernels import matmul as mm
    x = torch.ones(8, 8, device=cuda)
    n_threads, per_thread = 32, 50
    before = mm.matmul.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [mm.matmul(x, x) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + n_threads * per_thread


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import matmul as mm
    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        mm.matmul(x.half(), x.half())
    with pytest.raises(ValueError):
        mm.matmul(x.t(), x)                       # not contiguous
    with pytest.raises(ValueError):
        mm.matmul(x, x.cpu())


def test_threaded_equals_sequential_on_the_card(cuda):
    from repro_torch.kernels import matmul as mm
    from repro_torch.workloads import run_matrix_dag
    before = mm.matmul.launches
    g, seq, _ = run_matrix_dag(6, 512, 1)
    g2, par, _ = run_matrix_dag(6, 512, 4)
    assert mm.matmul.launches == before + 12
    for tid, a in seq.items():
        b = par[tid]
        if isinstance(a, torch.Tensor):
            assert a.is_cuda
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert a == b
