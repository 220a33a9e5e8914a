"""The port's CUDA kernels and paths on the card.

Marked ``gpu``: each test skips inside itself when no CUDA device is
present.  On the card run ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Kernel tolerances: ``tests/test_kernels.py``'s matmul tolerances (2e-5
float32, 2e-2 bfloat16) applied to ``out / sqrt(K)``, against the plain
version with TF32 off; its ssm tolerances (1e-4 float32, 5e-2 bfloat16)
for the selective scan; its flash tolerances (2e-5 float32, 2e-2 bfloat16)
for flash attention.
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


# the bf16 shapes with K % 8 == 0 and N % 8 == 0, which take the wgmma
# route; every other case takes the CUDA-core (simt) kernel
_MM_WGMMA = {(128, 128, 128), (1000, 1528, 776), (64, 64, 0)}


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (1000, 1531, 777),
                                   (1, 129, 7), (257, 3, 1), (64, 64, 0),
                                   (1000, 1528, 776)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, M, N, K, dtype):
    from repro_torch.kernels import matmul as mm, ref
    g = torch.Generator(device=cuda).manual_seed(M * 7 + N * 3 + K)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    y = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    path = ("wgmma" if dtype == torch.bfloat16 and (M, N, K) in _MM_WGMMA
            else "simt")
    assert mm.route(dtype, N, K) == path
    before = mm.matmul.launches
    before_route = mm.matmul.route_launches[path]
    got = mm.matmul(x, y)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    assert mm.matmul.route_launches[path] == before_route + 1
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


def test_wgmma_kernel_is_deterministic_across_launches(cuda):
    from repro_torch.kernels import matmul as mm
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(777, 1024, generator=g, device=cuda).bfloat16()
    y = torch.randn(1024, 336, generator=g, device=cuda).bfloat16()
    before = mm.matmul.route_launches["wgmma"]
    first = mm.matmul(x, y)
    for _ in range(3):
        assert torch.equal(mm.matmul(x, y).view(torch.int16),
                           first.view(torch.int16))
    assert mm.matmul.route_launches["wgmma"] == before + 4


# the persistent wgmma kernel's plans and edges: each tile shape, more tiles
# than blocks, rows and columns past M and N that TMA's store clips, and
# K = 8 and K < 64 (one partial stage)
@pytest.mark.parametrize("M,N,K,tile_n,more_tiles_than_blocks", [
    (1000, 1528, 776, 128, False),     # N 120 past a tile
    (4096 + 8, 4096, 64, 256, True),   # 8 rows past a tile: 33 rows, odd
    (4096, 4096, 64, 256, True),       # 512 tiles of 128x256
    (2560, 3840, 64, 128, True),       # 600 tiles of 128x128
    (1, 8, 64, 128, False),            # one row, 8 columns of a tile
    (129, 264, 8, 128, False),         # K = 8; one row and 8 columns past
    (4096, 4096, 8, 256, True),        # K = 8
    (4096, 4088, 40, 256, True),       # K < 64; N 248 past a tile
    (8, 100000, 16, 256, True),        # one row of 391 tiles
])
def test_wgmma_kernel_matches_plain_version_at_every_plan(
        cuda, M, N, K, tile_n, more_tiles_than_blocks):
    from repro_torch.kernels import matmul as mm, ref
    p = mm.plan(M, N, mm.resident_blocks(cuda.index or 0))
    assert p.tile_n == tile_n
    assert (p.tiles_m * p.tiles_n > p.blocks) == more_tiles_than_blocks
    g = torch.Generator(device=cuda).manual_seed(M + 3 * N + 7 * K)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    y = torch.randn(K, N, generator=g, device=cuda).bfloat16()
    assert mm.route(x.dtype, N, K) == "wgmma"
    before = mm.matmul.route_launches["wgmma"]
    got = mm.matmul(x, y)
    torch.cuda.synchronize()
    assert mm.matmul.route_launches["wgmma"] == before + 1
    s = math.sqrt(K)
    assert torch.allclose(got.float() / s, ref.matmul(x, y).float() / s,
                          rtol=TOL[x.dtype], atol=TOL[x.dtype])


def test_wgmma_bits_do_not_depend_on_the_plan(cuda):
    # an element's sum is one fixed sequence of k16 products whatever the
    # tile's width, the block that runs it or the tile order: the C entry
    # given other plans writes the wrapper's bits
    from repro_torch.kernels import _build, matmul as mm
    g = torch.Generator(device=cuda).manual_seed(11)
    M, N, K = 1000, 1528, 776
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    y = torch.randn(K, N, generator=g, device=cuda).bfloat16()
    want = mm.matmul(x, y)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for tile_n, blocks, group in ((256, 48, 1), (128, 2, 1), (128, 6, 4),
                                  (256, 10, 4)):
        out = torch.empty_like(want)
        err = _build.library().repro_matmul_bf16_wgmma(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, tile_n,
            blocks, group, cuda.index or 0, stream)
        _build.check(err, "matmul kernel launch")
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), want.view(torch.int16)), (
            tile_n, blocks, group)


def test_wgmma_wrappers_reject_misaligned_pointers(cuda):
    # a contiguous bf16 tensor 2 bytes past a 16-byte boundary is no TMA
    # base: both wrappers send it to the CUDA-core (simt) kernel, which
    # computes the same function, instead of refusing it
    from repro_torch.kernels import flash_attention as fa, matmul as mm, ref
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(64 * 64 + 1, generator=g, device=cuda).bfloat16()
    x = buf[1:].view(64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    y = torch.randn(64, 64, generator=g, device=cuda).bfloat16()
    assert mm.route(x.dtype, 64, 64, aligned=False) == "simt"
    for a, b in ((x, y), (y, x)):
        before = dict(mm.matmul.route_launches)
        got = mm.matmul(a, b)
        torch.cuda.synchronize()
        assert mm.matmul.route_launches == {
            "wgmma": before["wgmma"], "simt": before["simt"] + 1}
        assert torch.allclose(got.float() / 8, ref.matmul(a, b).float() / 8,
                              rtol=TOL[a.dtype], atol=TOL[a.dtype])
    q = x.view(1, 1, 64, 64)
    kv = y.view(1, 1, 64, 64)
    assert fa.route(q.dtype, 64, aligned=False) == "simt"
    for args in ((q, kv, kv), (kv, kv, q)):
        before = dict(fa.flash_attention.route_launches)
        got = fa.flash_attention(*args)
        torch.cuda.synchronize()
        assert fa.flash_attention.route_launches == {
            "wgmma": before["wgmma"], "simt": before["simt"] + 1}
        assert torch.allclose(got.float(), ref.attention(*args).float(),
                              rtol=TOL[q.dtype], atol=TOL[q.dtype])


# the simt kernel's edges: its tiles are 16 deep and 128 x 128 on a grid of
# at least 264 of them, else 64 x 128; its vector variant needs N % 4 == 0
# and 16-byte aligned pointers
@pytest.mark.parametrize("M,N,K,offset,want", [
    (200, 136, 20, 0, "vector"),      # K % 4 == 0, not a multiple of 16
    (64, 64, 12, 0, "vector"),        # K < 16
    (31, 44, 4, 0, "vector"),
    (130, 130, 64, 0, "scalar"),      # N % 4 != 0, K % 4 == 0
    (100, 128, 96, 1, "scalar"),      # base 4 bytes past a 16-byte boundary
    (129, 132, 33, 0, "vector"),      # one row and 4 columns past a tile
    (257, 129, 129, 0, "scalar"),     # one past a tile in every dim
    (2177, 2052, 36, 0, "vector"),    # 128-row tiles, past their edges
    (2177, 2049, 20, 0, "scalar"),
    (1, 1, 1, 0, "scalar")])
def test_simt_kernel_edges_and_load_variants(cuda, M, N, K, offset, want):
    from repro_torch.kernels import matmul as mm, ref
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    x = torch.randn(M * K + offset, generator=g, device=cuda)[offset:]
    x = x.view(M, K)
    y = torch.randn(K, N, generator=g, device=cuda)
    aligned = x.data_ptr() % 16 == 0
    assert aligned == (offset == 0)
    assert mm.variant(x.dtype, N, K, aligned=aligned) == want
    before = mm.matmul.route_launches["simt"]
    got = mm.matmul(x, y)
    torch.cuda.synchronize()
    assert mm.matmul.route_launches["simt"] == before + 1
    s = math.sqrt(K)
    want_out = ref.matmul(x, y)
    assert torch.allclose(got / s, want_out / s, rtol=TOL[x.dtype],
                          atol=TOL[x.dtype])
    # the same chain of fmaf in both variants: equal bits
    if want == "vector":
        xs = torch.randn(M * K + 1, generator=g, device=cuda)[1:].view(M, K)
        xs.copy_(x)
        assert mm.variant(x.dtype, N, K, aligned=False) == "scalar"
        assert torch.equal(mm.matmul(xs, y).view(torch.int32),
                           got.view(torch.int32))


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


def test_process_backend_equals_sequential_on_the_card(cuda):
    """The Fig. 2 DAG on cluster workers, which spawn because this process
    has initialised CUDA and each launch the matmul kernel (simt route,
    vector loads), is bit for bit the sequential run on the card."""
    from repro_torch.config import ClusterConfig
    from repro_torch.kernels import matmul as mm
    from repro_torch.workloads import run_matrix_dag
    g, seq, _ = run_matrix_dag(4, 512, 1)
    for fuse in ("off", "auto"):
        before = mm.matmul.launches
        _, got, rep = run_matrix_dag(4, 512, 2, backend="process",
                                     config=ClusterConfig(
                                         fuse=fuse, progress_timeout=120.0))
        assert rep["start_method"] == "spawn"
        assert mm.matmul.launches == before
        assert rep["stats"]["tasks_run"]["mul"] == 4
        assert rep["stats"]["kernel_launches"] == {
            "matmul": 4, "matmul/simt": 4, "matmul/vector": 4}
        assert got.keys() == seq.keys()
        for tid, a in seq.items():
            b = got[tid]
            if isinstance(a, torch.Tensor):
                assert b.is_cuda
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            else:
                assert a == b
        assert rep["stats"]["recomputed"] == 0


def test_gateway_runs_the_fig2_dag_on_the_card(cuda):
    """A 2-worker spawned gateway runs a small Fig. 2 DAG on the card bit
    for bit the sequential run; the job's workers report one matmul launch
    (simt route, vector loads) per ``mul``, and this process makes none."""
    from repro_torch.config import ClusterConfig
    from repro_torch.core import trace
    from repro_torch.gateway import GatewayService, connect
    from repro_torch.kernels import matmul as mm
    from repro_torch.workloads import matrix_driver, run_matrix_dag
    _, seq, _ = run_matrix_dag(4, 512, 1)
    g, _ = trace(matrix_driver, 4, 512, device=cuda)
    before = mm.matmul.launches
    with GatewayService(ClusterConfig(n_workers=2, token="t", fuse="auto",
                                      progress_timeout=120.0)) as gw:
        assert gw.executor.start_method == "spawn"
        with connect(gw.address, token="t", tenant="gpu") as c:
            fut = c.submit(g)
            got = fut.result(300)
    assert mm.matmul.launches == before
    assert fut.stats["tasks_run"]["mul"] == 4
    assert fut.stats["kernel_launches"] == {
        "matmul": 4, "matmul/simt": 4, "matmul/vector": 4}
    assert got.keys() == seq.keys()
    for tid, a in seq.items():
        b = got[tid]
        if isinstance(a, torch.Tensor):
            assert b.is_cuda
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert a == b


def test_cuda_tensors_cross_the_data_plane_on_their_device(cuda):
    from repro_torch.cluster import serde
    t = torch.randn(300, 257, device=cuda).to(torch.bfloat16)
    enc = serde.encode({"t": t}, transport="shm", threshold=1024)
    try:
        got = serde.decode(enc)["t"]
    finally:
        serde.release(enc)
    assert got.device == t.device and got.dtype == t.dtype
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    assert enc.direct_nbytes() == t.numel() * 2


def _touch_cuda():
    return torch.ones(1, device="cuda")


def test_a_forked_worker_that_touches_cuda_fails_its_task(cuda):
    """Once the driver has used CUDA a forked child cannot: the task fails
    with torch's message instead of hanging the driver."""
    from repro_torch.config import ClusterConfig
    from repro_torch.core import TaskFailed, TaskGraph, TaskKind, run_graph
    torch.ones(1, device=cuda)
    g = TaskGraph()
    g.mark_output(g.add_node("touch", _touch_cuda, (), {}, TaskKind.PURE,
                             deps=()))
    with pytest.raises(TaskFailed, match="forked subprocess"):
        run_graph(g, 1, backend="process", config=ClusterConfig(
            start_method="fork", progress_timeout=60.0))


# ------------------------------------------------------------- ssm scan

SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _scan_inputs(device, Bsz, S, D, N, dtype, with_h0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(Bsz, S, D, generator=g, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn(Bsz, S, D, generator=g, device=device) - 3.0)
    B = torch.randn(Bsz, S, N, generator=g, device=device)
    C = torch.randn(Bsz, S, N, generator=g, device=device)
    A = -torch.arange(1, N + 1, device=device, dtype=torch.float32).expand(
        D, N).contiguous()
    h0 = (torch.randn(Bsz, D, N, generator=g, device=device)
          if with_h0 else None)
    return [t.to(dtype) for t in (x, dt, B, C)] + [A, h0]


# the kernel stages 32 steps a chunk, gives a thread 4 states of a channel
# and a block 32 channels: S = 33 and 64 are one step past a chunk and two
# whole chunks, N = 3, 7, 9 and 5 no multiple of 4, D = 33 and 65 one
# channel past a block
@pytest.mark.parametrize("Bsz,S,D,N", [(3, 1000, 1000, 16), (2, 37, 100, 5),
                                       (1, 1, 8192, 16), (2, 0, 64, 16),
                                       (1, 130, 17, 32), (4, 65, 129, 1),
                                       (1, 64, 48, 9), (1, 33, 33, 3),
                                       (2, 64, 65, 7), (1, 33, 40, 32),
                                       (3, 64, 33, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_matches_plain_version(cuda, Bsz, S, D, N, with_h0,
                                               dtype):
    from repro_torch.kernels import ref, ssm_scan as scan
    args = _scan_inputs(cuda, Bsz, S, D, N, dtype, with_h0, seed=S + D)
    before = scan.ssm_scan.launches
    y, h = scan.ssm_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert scan.ssm_scan.launches == before + 1
    assert y.shape == (Bsz, S, D) and y.dtype == dtype
    assert h.shape == (Bsz, D, N) and h.dtype == torch.float32
    want_y, want_h = ref.ssm_scan(*args, return_state=True)
    tol = SCAN_TOL[dtype]
    assert torch.allclose(y.float(), want_y.float(), rtol=tol, atol=tol)
    assert torch.allclose(h, want_h, rtol=tol, atol=tol)
    if S == 0:
        assert torch.equal(h, args[5] if with_h0 else torch.zeros_like(h))


def test_ssm_scan_kernel_is_deterministic_across_launches(cuda):
    from repro_torch.kernels import ssm_scan as scan
    args = _scan_inputs(cuda, 2, 300, 700, 16, torch.float32, True)
    y0, h0 = scan.ssm_scan(*args, return_state=True)
    for _ in range(2):
        y, h = scan.ssm_scan(*args, return_state=True)
        assert torch.equal(y.view(torch.int32), y0.view(torch.int32))
        assert torch.equal(h.view(torch.int32), h0.view(torch.int32))


def test_ssm_scan_launch_counter_loses_no_update_under_threads(cuda):
    import sys
    import threading
    from repro_torch.kernels import ssm_scan as scan
    args = _scan_inputs(cuda, 1, 4, 32, 4, torch.float32, False)
    n_threads, per_thread = 32, 50
    before = scan.ssm_scan.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [scan.ssm_scan(*args) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert scan.ssm_scan.launches == before + n_threads * per_thread


def test_ssm_scan_wrapper_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import ssm_scan as scan
    x, dt, B, C, A, h0 = _scan_inputs(cuda, 1, 8, 16, 4, torch.float32, True)
    with pytest.raises(TypeError):
        scan.ssm_scan(x.half(), dt.half(), B.half(), C.half(), A)
    with pytest.raises(TypeError):
        scan.ssm_scan(x, dt, B, C, A.double())
    with pytest.raises(ValueError):
        scan.ssm_scan(x, dt, B, C, A.cpu())
    not_contiguous = torch.randn(1, 4, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        scan.ssm_scan(x, dt, not_contiguous, C, A)
    big = _scan_inputs(cuda, 1, 2, 16, 33, torch.float32, False)
    with pytest.raises(ValueError):
        scan.ssm_scan(*big[:5])                            # N > 32


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba1_block_kernel_matches_plain_scan(cuda, compute_dtype):
    from repro_torch.configs import get_config
    from repro_torch.models import ssm, transformer as TF
    cfg = get_config("falcon-mamba-7b").reduced(
        d_model=512, n_layers=2, compute_dtype=compute_dtype)
    params = TF.init_params(cfg, seed=0, device=cuda)
    mixer = {k: v[0] for k, v in params["layers"]["mixer"].items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 77, cfg.d_model, generator=g,
                    device=cuda).to(cfg.cdtype)
    cache = ssm.mamba1_decode_cache(cfg, 2, cfg.cdtype, cuda)
    cache["h"].normal_(generator=g)
    got, got_cache = ssm.mamba1_block(mixer, x, cfg, cache=cache)
    want, want_cache = ssm.mamba1_block(mixer, x, cfg, cache=cache,
                                        impl="ref")
    # bf16 compute rounds the scan's output once more; 5e-2 as for bf16
    tol = 1e-4 if compute_dtype == "float32" else 5e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.allclose(got_cache["h"], want_cache["h"], rtol=1e-4,
                          atol=1e-4)


def test_forward_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    cfg = get_config("falcon-mamba-7b").reduced()
    params = TF.init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    want, _, _ = TF.forward(params, toks, cfg)
    on_card = {k: {kk: (vv.to(cuda) if not isinstance(vv, dict) else
                        {k3: v3.to(cuda) for k3, v3 in vv.items()})
                   for kk, vv in v.items()} for k, v in params.items()}
    got, _, _ = TF.forward(on_card, toks.to(cuda), cfg)
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)


# (Bsz, S, D, N, with h0 and dh_final): the training step's scan
# (falcon-mamba-7b at 2 x 2048 tokens), the long prefill's, a ragged one,
# N = 1 and N = 32, S = 1, S = 0, a chunk and a step (the backward kernel
# keeps the state every 16 steps), and the reduced config's (2 x 16, d_inner
# 256)
SCAN_GRAD_SHAPES = [(2, 2048, 8192, 16, False), (1, 2048, 8192, 16, False),
                    (3, 1000, 1000, 16, True), (2, 37, 100, 1, True),
                    (1, 130, 17, 32, True), (2, 1, 64, 16, True),
                    (2, 0, 64, 16, True), (1, 17, 33, 9, True),
                    (2, 16, 256, 16, False)]


def _scan_grad_args(cuda, Bsz, S, D, N, with_states):
    x, dt, B, C, A, h0 = _scan_inputs(cuda, Bsz, S, D, N, torch.float32,
                                      with_states, seed=S + D + N)
    g = torch.Generator(device=cuda).manual_seed(S * N + 1)
    dy = torch.randn(Bsz, S, D, generator=g, device=cuda)
    dh = (torch.randn(Bsz, D, N, generator=g, device=cuda)
          if with_states else None)
    return x, dt, B, C, A, h0, dy, dh


@pytest.mark.parametrize("Bsz,S,D,N,with_states", SCAN_GRAD_SHAPES)
def test_ssm_scan_backward_kernel_matches_plain_version(cuda, Bsz, S, D, N,
                                                        with_states):
    """The backward kernel against ref.ssm_scan_backward: every gradient
    within 1e-4 of its largest plain entry (the scan's float32 tolerance;
    the two differ in the exp, the kernel's ex2.approx, and in summation
    order), and two launches give the same bits."""
    from repro_torch.kernels import ref, ssm_scan as scan
    args = _scan_grad_args(cuda, Bsz, S, D, N, with_states)
    before = scan.ssm_scan_backward.launches
    got = scan.ssm_scan_backward(*args)
    again = scan.ssm_scan_backward(*args)
    torch.cuda.synchronize()
    assert scan.ssm_scan_backward.launches == before + 2
    want = ref.ssm_scan_backward(*args)
    for name, g, a, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got,
                             again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), a.view(torch.int32)), name
        if w.numel():
            err = (g - w).abs().max() / w.abs().max().clamp_min(1e-30)
            assert err <= SCAN_TOL[torch.float32], (name, err)
    if S == 0:
        assert torch.equal(got[5], args[7])


# (Bsz, S, D, N): the training forward's shape, a ragged one, N = 1 and
# N = 32, S one step past a state chunk (16 steps) and on one, the reduced
# config's, S = 0
SCAN_STATE_SHAPES = [(2, 2048, 8192, 16), (3, 1000, 1000, 16),
                     (2, 37, 100, 1), (1, 130, 17, 32), (1, 17, 33, 9),
                     (2, 16, 256, 16), (2, 0, 64, 16)]


@pytest.mark.parametrize("Bsz,S,D,N", SCAN_STATE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_states_match_plain_version(cuda, Bsz, S, D, N,
                                                    dtype):
    """The forward kernel's states (the state before every 16 steps)
    against ref.ssm_scan's within the scan's float32 tolerance (both widen
    bf16 inputs to float32 exactly); keeping them changes no bit of y or
    h_final, and the first is h0."""
    from repro_torch.kernels import ref, ssm_scan as scan
    args = _scan_inputs(cuda, Bsz, S, D, N, dtype, True, seed=S + N)
    y, h, states = scan.ssm_scan(*args, return_states=True)
    y0, h0 = scan.ssm_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert states.shape == (Bsz, -(-S // 16), D, N)
    assert states.dtype == torch.float32
    assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       y0.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32))
    assert torch.equal(h.view(torch.int32), h0.view(torch.int32))
    want = ref.ssm_scan(*args, return_states=True)[2]
    tol = SCAN_TOL[torch.float32]
    assert torch.allclose(states, want, rtol=tol, atol=tol)
    if S:
        assert torch.equal(states[:, 0], args[5])


@pytest.mark.parametrize("Bsz,S,D,N,with_states", SCAN_GRAD_SHAPES)
def test_ssm_scan_backward_kernel_given_states_equals_standalone_route(
        cuda, Bsz, S, D, N, with_states):
    """The backward kernel given the forward kernel's states gives the bits
    of the wrapper's standalone route (which launches the forward kernel
    for them), and two launches give the same bits."""
    from repro_torch.kernels import ssm_scan as scan
    args = _scan_grad_args(cuda, Bsz, S, D, N, with_states)
    x, dt, B, C, A, h0 = args[:6]
    fwd, bwd = scan.ssm_scan.launches, scan.ssm_scan_backward.launches
    states = scan.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
    given = scan.ssm_scan_backward(*args, states=states)
    again = scan.ssm_scan_backward(*args, states=states)
    assert scan.ssm_scan.launches == fwd + 1
    alone = scan.ssm_scan_backward(*args)
    torch.cuda.synchronize()
    assert scan.ssm_scan.launches == fwd + 2
    assert scan.ssm_scan_backward.launches == bwd + 3
    for name, g, a, s in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), given,
                             again, alone):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32)), name
        assert torch.equal(g.view(torch.int32), s.view(torch.int32)), name


def test_ssm_scan_function_launches_one_forward_and_one_backward(cuda):
    """SSMScan's forward keeps the kernel's states, so its backward
    launches the backward kernel and no forward of its own."""
    from repro_torch.kernels import ops, ssm_scan as scan
    x, dt, B, C, A, h0 = _scan_inputs(cuda, 2, 300, 256, 16, torch.float32,
                                      True)
    ins = [t.clone().requires_grad_() for t in (x, dt, B, C, A, h0)]
    fwd, bwd = scan.ssm_scan.launches, scan.ssm_scan_backward.launches
    y = ops.ssm_scan(*ins)
    torch.autograd.grad(y, ins, torch.ones_like(y))
    torch.cuda.synchronize()
    assert (scan.ssm_scan.launches, scan.ssm_scan_backward.launches) == \
        (fwd + 1, bwd + 1)


def test_ssm_scan_function_gradient_matches_plain_autograd(cuda):
    """SSMScan on the card (the scan kernel, then its backward kernel)
    against autograd of the plain scan, bf16 inputs included (gradients
    computed in float32 and cast back)."""
    from repro_torch.kernels import ops, ref, ssm_scan as scan
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, B, C, A, h0 = _scan_inputs(cuda, 2, 77, 96, 16, dtype, True)
        dy = torch.randn(2, 77, 96, device=cuda).to(dtype)
        grads = {}
        for impl in ("kernel", "ref"):
            ins = [t.clone().requires_grad_() for t in (x, dt, B, C, A, h0)]
            y = ops.ssm_scan(*ins, impl=impl)
            grads[impl] = torch.autograd.grad(y, ins, dy)
        for g, w in zip(grads["kernel"], grads["ref"]):
            assert g.dtype == w.dtype
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err <= SCAN_TOL[dtype], err


def test_ssm_scan_backward_wrapper_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import ssm_scan as scan
    x, dt, B, C, A, h0, dy, dh = _scan_grad_args(cuda, 1, 8, 16, 4, True)
    bf = [t.to(torch.bfloat16) for t in (x, dt, B, C)]
    with pytest.raises(TypeError):
        scan.ssm_scan_backward(*bf, A, h0, dy, dh)
    with pytest.raises(TypeError):
        scan.ssm_scan_backward(x, dt, B, C, A, h0, dy.double(), dh)
    with pytest.raises(ValueError):
        scan.ssm_scan_backward(x, dt, B, C, A, h0, dy.cpu(), dh)
    with pytest.raises(ValueError):
        scan.ssm_scan_backward(x, dt, B, C, A, h0,
                               dy.transpose(1, 2).contiguous()
                               .transpose(1, 2), dh)
    big = _scan_grad_args(cuda, 1, 2, 16, 33, False)
    with pytest.raises(ValueError):
        scan.ssm_scan_backward(*big)                       # N > 32
    states = scan.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
    with pytest.raises(ValueError, match="states"):
        scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh,
                               states=states[:, :0])
    with pytest.raises(TypeError):
        scan.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh,
                               states=states.double())


# ------------------------------------------------------- flash attention

def _attn_inputs(device, B, H, KH, Sq, Sk, D, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g, device=device).to(dtype)
    k = torch.randn(B, KH, Sk, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, KH, Sk, D, generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", [
    (1, 28, 4, 2048, 2048, 128),    # qwen2-7b's long prefill
    (1, 28, 4, 12, 12, 128),        # a served prefill
    (2, 8, 2, 1000, 1000, 64),      # ragged, GQA
    (2, 4, 2, 300, 777, 112),       # cross-shaped, Sq < Sk
    (1, 4, 1, 129, 64, 32),         # cross-shaped, Sq > Sk, MQA
    (3, 6, 3, 65, 65, 1),
    (1, 2, 2, 5, 0, 16),            # no keys: zeros
    (1, 4, 2, 200, 333, 72),        # D % 16 != 0, Sk not a tile multiple
    (1, 14, 2, 100, 300, 128),      # GQA group 7 (qwen2-7b's), Sq < Sk
    (2, 7, 1, 333, 129, 64),        # group 7, Sq > Sk
    (2, 6, 6, 1500, 1500, 64),      # whisper-tiny's encoder
    (2, 6, 6, 448, 1500, 64),       # its cross-attention
    (2, 6, 6, 1, 1500, 64),         # its cross-attention in a decode step
    (1, 56, 8, 512, 512, 128)])     # llava-next-34b's heads, GQA 7
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda, B, H, KH, Sq, Sk,
                                                      D, causal, dtype):
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = _attn_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, seed=Sq + Sk)
    # every bf16 case here has D % 8 == 0 except D = 1
    path = "wgmma" if dtype == torch.bfloat16 and D != 1 else "simt"
    assert fa.route(dtype, D) == path
    before = fa.flash_attention.launches
    before_route = fa.flash_attention.route_launches[path]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.route_launches[path] == before_route + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = ref.attention(q, k, v, causal=causal)
    assert torch.allclose(got.float(), want.float(), rtol=TOL[dtype],
                          atol=TOL[dtype])
    if Sk == 0:
        assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_kernel_is_deterministic_across_launches(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, 8, 2, 700, 700, 128, torch.float32)
    first = fa.flash_attention(q, k, v)
    for _ in range(2):
        assert torch.equal(fa.flash_attention(q, k, v).view(torch.int32),
                           first.view(torch.int32))


def test_flash_attention_wgmma_is_deterministic_across_launches(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, 8, 2, 700, 700, 128, torch.bfloat16)
    before = fa.flash_attention.route_launches["wgmma"]
    first = fa.flash_attention(q, k, v)
    for _ in range(2):
        assert torch.equal(fa.flash_attention(q, k, v).view(torch.int16),
                           first.view(torch.int16))
    assert fa.flash_attention.route_launches["wgmma"] == before + 3


# The wgmma forward (csrc/flash_attention_wgmma.cu): min(units, SMs)
# persistent blocks walk forward_schedule's heaviest-first list of (128-row
# query tile, head, batch) units, and a TMA store writes each unit's out.
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", [
    (2, 28, 4, 2048, 2048, 128, True),  # 896 units: 7 a block on 132 SMs
    (1, 28, 4, 12, 12, 128, True),      # 28 units: fewer blocks than SMs
    (1, 48, 1, 2048, 2048, 128, True),  # granite-20b's MQA
    (1, 4, 2, 200, 333, 72, True),      # D = 72: the store clips columns
    (2, 32, 32, 300, 300, 112, True),   # D = 112, a ragged last tile
    (3, 6, 6, 1500, 1500, 64, False),   # D = 64: the 5-stage ring
    (2, 7, 1, 333, 129, 64, True),      # Sq > Sk, GQA 7
    (16, 6, 6, 1, 1500, 64, False),     # one query a head: a decode step
    (1, 2, 1, 5, 0, 64, True),          # Sk = 0: zeros, lse -inf
    (2, 3, 3, 130, 0, 128, False)])     # Sk = 0 over two query tiles
def test_wgmma_forward_persistent_edges_and_bits(cuda, B, H, KH, Sq, Sk, D,
                                                 causal):
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = _attn_inputs(cuda, B, H, KH, Sq, Sk, D, torch.bfloat16,
                           seed=Sq + Sk + D)
    assert fa.route(torch.bfloat16, D) == "wgmma"
    before = fa.flash_attention.route_launches["wgmma"]
    got, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    again, lse_again = fa.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    serving = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.route_launches["wgmma"] == before + 3
    want, want_lse = ref.attention(q, k, v, causal=causal, return_lse=True)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    for a, b in ((got, again), (got, serving), (lse, lse_again)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if Sk == 0:
        assert torch.equal(got, torch.zeros_like(got))
        assert bool((lse == float("-inf")).all())


def test_flash_attention_launch_counter_loses_no_update_under_threads(cuda):
    import sys
    import threading
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 2, 1, 4, 4, 8, torch.float32)
    n_threads, per_thread = 32, 50
    before = fa.flash_attention.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fa.flash_attention(q, k, v)
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + n_threads * per_thread


def test_flash_attention_wrapper_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 4, 2, 8, 8, 16, torch.float32)
    with pytest.raises(ValueError):                       # D > 128
        fa.flash_attention(*_attn_inputs(cuda, 1, 2, 1, 4, 4, 129,
                                         torch.float32))
    with pytest.raises(TypeError):                        # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):                        # float16
        fa.flash_attention(q.half(), k.half(), v.half())
    not_contiguous = torch.randn(1, 4, 16, 8, device=cuda).transpose(2, 3)
    assert not_contiguous.shape == q.shape
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(not_contiguous, k, v)
    with pytest.raises(ValueError):                       # H % KH != 0
        fa.flash_attention(*_attn_inputs(cuda, 1, 3, 2, 4, 4, 16,
                                         torch.float32))
    with pytest.raises(ValueError):                       # devices differ
        fa.flash_attention(q, k.cpu(), v)


# The simt kernel (csrc/flash_attention.cu): 64-row query tiles and 32-key
# tiles in a 2-stage cp.async ring; the last three shapes' grids are under
# the SM count.  bf16 reaches it with D % 8 != 0 or through q, k, v one
# element past a 16-byte boundary.
def _misaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", [
    (1, 4, 4, 97, 161, 128, True),    # no tile multiple, GQA 1
    (1, 8, 2, 161, 97, 64, True),     # Sq > Sk, GQA 4
    (2, 7, 1, 130, 250, 72, True),    # GQA 7
    (2, 7, 1, 33, 65, 127, False),
    (3, 4, 2, 70, 70, 1, True),
    (1, 4, 2, 70, 70, 32, True),
    (1, 4, 2, 12, 12, 32, True),      # phase 9b's reduced qwen2-7b prefill
    (1, 2, 1, 5, 0, 64, True),        # Sk = 0: zeros
    (1, 4, 1, 64, 4096, 128, False),  # 4 blocks
    (1, 8, 2, 300, 777, 128, False),  # 40 blocks
    (1, 2, 1, 1000, 1000, 128, True)])  # 32 blocks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simt_flash_kernel_edges_and_bits(cuda, B, H, KH, Sq, Sk, D, causal,
                                          dtype):
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = _attn_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, seed=Sq * Sk)
    if dtype == torch.bfloat16 and D % 8 == 0:
        q, k, v = (_misaligned(t) for t in (q, k, v))
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    assert fa.route(dtype, D, aligned=aligned) == "simt"
    before = fa.flash_attention.route_launches["simt"]
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.route_launches["simt"] == before + 2
    assert got.shape == q.shape and got.dtype == dtype
    want = ref.attention(q, k, v, causal=causal)
    assert torch.allclose(got.float(), want.float(), rtol=TOL[dtype],
                          atol=TOL[dtype])
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    if Sk == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_forward_kernel_matches_plain_attention(cuda, compute_dtype):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as TF
    cfg = get_config("qwen2-7b").reduced(compute_dtype=compute_dtype,
                                         d_model=512, n_heads=8,
                                         n_kv_heads=2, head_dim=128)
    params = TF.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 77), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = fa.flash_attention.launches
    got, _, _ = TF.forward(params, toks, cfg)
    assert fa.flash_attention.launches == before + cfg.n_layers
    want, _, _ = TF.forward(params, toks, cfg, impl="ref")
    assert fa.flash_attention.launches == before + cfg.n_layers
    # bf16 compute rounds each layer's attention output to bf16, so a
    # last-bit difference can flip a rounding: 5e-2 as for the scan
    tol = 1e-4 if compute_dtype == "float32" else 5e-2
    assert torch.allclose(got, want, rtol=tol, atol=tol)


def test_dense_forward_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    cfg = get_config("qwen2-7b").reduced()
    params = TF.init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    prefill = TF.make_prefill_step(cfg, max_len=48)
    decode = TF.make_decode_step(cfg)
    want, cache = prefill(params, toks)
    want_step, _ = decode(params, cache, toks[:, :1])

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    on_card = to_card(params)
    got, cache = prefill(on_card, toks.to(cuda))
    got_step, _ = decode(on_card, cache, toks[:, :1].to(cuda))
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.allclose(got_step.cpu(), want_step, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_hybrid_prefill_and_decode_on_the_card(cuda, compute_dtype):
    """zamba2's hybrid at a narrow width with its head dim of 112 (the
    reduced config with two shared-attention sites): prefill launches the
    flash kernel once a site, on the route of the compute dtype, and decode
    none.  In float32 the card's logits meet the CPU's at 1e-4; in bf16
    the kernel's meet the plain attention's on the card at 5e-2 (the wgmma
    route rounds P to bf16, and each layer's output is rounded)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as TF
    cfg = get_config("zamba2-7b").reduced(
        n_layers=4, shared_attn_every=2, compute_dtype=compute_dtype,
        n_heads=4, n_kv_heads=4, head_dim=112)
    params = TF.init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    on_card = to_card(params)

    def run(tree, device, impl):
        prefill = TF.make_prefill_step(cfg, max_len=48, impl=impl)
        decode = TF.make_decode_step(cfg, impl=impl)
        last, cache = prefill(tree, toks.to(device))
        step, cache = decode(tree, cache, toks[:, :1].to(device))
        return last.cpu(), step.cpu(), cache

    route = fa.route(cfg.cdtype, cfg.head_dim)
    before = (fa.flash_attention.launches,
              fa.flash_attention.route_launches[route])
    got, got_step, cache = run(on_card, cuda, "kernel")
    assert (fa.flash_attention.launches,
            fa.flash_attention.route_launches[route]) == \
        (before[0] + 2, before[1] + 2)
    assert tuple(cache["shared"]["k"].shape) == (2, 2, 48, 4, 112)
    if compute_dtype == "float32":
        want, want_step, _ = run(params, "cpu", "kernel")
        tol = 1e-4
    else:
        want, want_step, _ = run(on_card, cuda, "ref")
        tol = 5e-2
    assert fa.flash_attention.launches == before[0] + 2
    assert torch.allclose(got, want, rtol=tol, atol=tol)
    assert torch.allclose(got_step, want_step, rtol=tol, atol=tol)


def test_dense_prefill_launches_flash_per_layer_on_wgmma(cuda):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as TF
    # qwen2-7b's depth, head dim and GQA group of 7, at a narrow width
    cfg = get_config("qwen2-7b").reduced(
        compute_dtype="bfloat16", n_layers=28, d_model=256, n_heads=7,
        n_kv_heads=1, head_dim=128)
    params = TF.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 77), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    prefill = TF.make_prefill_step(cfg, max_len=80)
    decode = TF.make_decode_step(cfg)
    before = dict(fa.flash_attention.route_launches)
    last, cache = prefill(params, toks)
    after_prefill = dict(fa.flash_attention.route_launches)
    step, _ = decode(params, cache, toks[:, :1])
    torch.cuda.synchronize()
    assert after_prefill == {"wgmma": before["wgmma"] + 28,
                             "simt": before["simt"]}
    assert fa.flash_attention.route_launches == after_prefill
    assert torch.isfinite(last).all() and torch.isfinite(step).all()


def test_reduced_moe_serves_on_the_card_as_on_the_cpu(cuda):
    """The reduced dbrx-132b (top-2 of 4 experts, float32 compute) served
    on the card from the CPU's parameter draw gives the CPU run's tokens,
    with one flash launch a layer a prefill (the simt route in float32)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    cfg = get_config("dbrx-132b").reduced()
    params = TF.init_params(cfg, seed=0, device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    argv = ["--arch", "dbrx-132b", "--reduced", "--requests", "3",
            "--slots", "2", "--max-new", "5"]
    want = serve.main(argv + ["--device", "cpu"], params=params)
    before = dict(fa.flash_attention.route_launches)
    got = serve.main(argv + ["--device", "cuda"], params=to_card(params))
    assert got["device"].startswith("cuda")
    assert fa.flash_attention.route_launches == {
        "simt": before["simt"] + cfg.n_layers * got["prefills"],
        "wgmma": before["wgmma"]}
    assert {r.rid: r.out for r in got["finished"]} == \
        {r.rid: r.out for r in want["finished"]}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encdec_prefill_and_decode_on_the_card(cuda, compute_dtype):
    """whisper's encoder-decoder at a narrow width with its head dim of 64:
    a prefill launches the flash kernel at every encoder layer and at each
    decoder layer's self- and cross-attention, a decode step only at the
    cross-attention (one query over all the frames' keys), all on the
    compute dtype's route.  In float32 the card's logits meet the CPU's at
    1e-4; in bf16 the kernel's meet the plain attention's on the card
    within 2e-2 of the largest logit: the tied embedding, drawn at scale
    1, gives logits of tens, where one bf16 step of the hidden state moves
    a logit by tenths whatever its own size."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import encdec as ED
    cfg = get_config("whisper-tiny").reduced(
        compute_dtype=compute_dtype, n_heads=2, n_kv_heads=2, head_dim=64,
        enc_seq=150)
    params = ED.init_params(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g,
                         dtype=torch.int32)
    frames = (0.02 * torch.randn(2, cfg.enc_seq, cfg.d_model,
                                 generator=g)).to(cfg.cdtype)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    on_card = to_card(params)

    def run(tree, device, impl):
        prefill = ED.make_prefill_step(cfg, max_len=24, impl=impl)
        decode = ED.make_decode_step(cfg, impl=impl)
        last, cache = prefill(tree, toks[:, :-1].to(device),
                              frames.to(device))
        step, _ = decode(tree, cache, toks[:, -1:].to(device))
        return last.cpu(), step.cpu()

    route = fa.route(cfg.cdtype, cfg.head_dim)
    before = fa.flash_attention.route_launches[route]
    prefill = ED.make_prefill_step(cfg, max_len=24)
    _, cache = prefill(on_card, toks[:, :-1].to(cuda), frames.to(cuda))
    torch.cuda.synchronize()
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    assert fa.flash_attention.route_launches[route] == before + per_prefill
    ED.make_decode_step(cfg)(on_card, cache, toks[:, -1:].to(cuda))
    torch.cuda.synchronize()
    assert fa.flash_attention.route_launches[route] == \
        before + per_prefill + cfg.n_layers
    got, got_step = run(on_card, cuda, "kernel")
    if compute_dtype == "float32":
        want, want_step = run(params, "cpu", "kernel")
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        assert torch.allclose(got_step, want_step, rtol=1e-4, atol=1e-4)
    else:
        want, want_step = run(on_card, cuda, "ref")
        for g, w in ((got, want), (got_step, want_step)):
            assert (g - w).abs().max() <= 2e-2 * w.abs().max()


# --------------------------------------------------------------------------
# training: the flash Function's gradient, the wrappers' guard, a step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", [(1, 28, 4, 256, 256, 128),
                                            (2, 8, 2, 100, 100, 64),
                                            (1, 4, 1, 33, 70, 32),
                                            (2, 6, 6, 448, 1500, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradient_matches_plain_autograd(cuda, B, H, KH, Sq,
                                                        Sk, D, causal, dtype):
    """dq, dk, dv through the Function (the kernel's forward and the
    backward kernel, both on the route of the dtype) against autograd of the
    plain version, each within the forward's tolerance of the largest
    reference entry."""
    from repro_torch.kernels import flash_attention as fa, ops, ref
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        cuda, B, H, KH, Sq, Sk, D, dtype, seed=Sq + Sk))
    dout = torch.randn(B, H, Sq, D, device=cuda).to(dtype)
    path = fa.route(dtype, D)
    before = (fa.flash_attention.route_launches[path],
              fa.flash_attention_backward.route_launches[path])
    out = ops.flash_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.flash_attention.route_launches[path],
            fa.flash_attention_backward.route_launches[path]) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(ref.attention(q, k, v, causal=causal),
                               (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= TOL[dtype], err


# The backward kernels alone, given the forward kernel's out and lse, at
# small ragged shapes: the tiles' edges (64-row query tiles and 64-key tiles
# on simt; 128-row blocks and 64-row steps on wgmma), Sq != Sk both ways,
# Sq = 1, MHA, GQA and MQA, D = 72 (wgmma, a second box mostly zero-filled)
# and 20 (bf16 on simt).  "misaligned" copies every tensor one element past
# a 16-byte boundary, which the wgmma route refuses: bf16 runs the simt
# kernel then.
_BWD_SHAPES = [(1, 4, 4, 130, 130, 64), (2, 6, 2, 200, 77, 128),
               (1, 4, 1, 65, 300, 72), (2, 7, 1, 1, 129, 128),
               (1, 2, 2, 257, 257, 20), (1, 8, 2, 129, 129, 112)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", _BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,aligned", [(torch.float32, True),
                                           (torch.bfloat16, True),
                                           (torch.bfloat16, False)])
def test_flash_backward_kernel_matches_plain_autograd(cuda, B, H, KH, Sq, Sk,
                                                      D, causal, dtype,
                                                      aligned):
    """The backward kernel of each route against autograd of the plain
    attention on the same inputs, each gradient within the forward's
    tolerance of its largest reference entry; the forward kernel's lse
    against the plain version's; two launches the same bits, each one
    launch on the route ``route()`` gives."""
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = _attn_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, seed=Sq * Sk)
    dout = torch.randn(B, H, Sq, D, generator=torch.Generator(
        device=cuda).manual_seed(D), device=cuda).to(dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    want_lse = ref.attention(q, k, v, causal=causal, return_lse=True)[1]
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    args = [q, k, v, out, dout]
    if not aligned:
        args = [_misaligned(t) for t in args]
    path = fa.route(dtype, D, aligned=aligned)
    assert path == ("wgmma" if dtype == torch.bfloat16 and aligned and
                    D % 8 == 0 else "simt")
    before = fa.flash_attention_backward.route_launches[path]
    got = fa.flash_attention_backward(*args, lse, causal=causal)
    again = fa.flash_attention_backward(*args, lse, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.route_launches[path] == before + 2
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*leaves, causal=causal),
                               leaves, dout)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    # a gradient that is 0 in exact arithmetic (dq of a causal row that
    # sees one key: P = 1, so dS = dP - rowsum(dO o O) = 0) is held to the
    # largest entry of the three
    largest = max(w.float().abs().max() for w in want)
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g.view(bits), a.view(bits)), name
        scale = w.float().abs().max()
        err = (g.float() - w.float()).abs().max() / (
            scale if scale > 0 else largest)
        assert err <= TOL[dtype], (name, err)


# Causal units whose range is empty for one consumer (wgmma: keys 64-127 of
# the first dK/dV unit see no query when Sq <= 64; simt: a unit of one step
# leaves its second team idle) or for the whole unit (keys past every
# query), at D = 64 and 128 on every route.
_EMPTY_RANGE_SHAPES = [(1, 4, 2, 50, 128, 64), (1, 4, 2, 50, 300, 128),
                       (2, 6, 3, 64, 200, 64), (1, 2, 1, 130, 400, 128)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", _EMPTY_RANGE_SHAPES)
@pytest.mark.parametrize("dtype,aligned", [(torch.float32, True),
                                           (torch.bfloat16, True),
                                           (torch.bfloat16, False)])
def test_flash_backward_units_with_empty_ranges(cuda, B, H, KH, Sq, Sk, D,
                                                dtype, aligned):
    """The backward kernel on causal units with nothing to do for one
    consumer or for the whole unit, against autograd of the plain
    attention; the same bits on two launches, and each call one launch in
    ``launches`` and in ``route_launches`` of its route."""
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = _attn_inputs(cuda, B, H, KH, Sq, Sk, D, dtype, seed=Sq + Sk)
    dout = torch.randn(B, H, Sq, D, generator=torch.Generator(
        device=cuda).manual_seed(Sk), device=cuda).to(dtype)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    args = [q, k, v, out, dout]
    if not aligned:
        args = [_misaligned(t) for t in args]
    path = fa.route(dtype, D, aligned=aligned)
    bwd = fa.flash_attention_backward
    got = []
    for _ in range(2):
        before = (bwd.launches, dict(bwd.route_launches))
        got.append(bwd(*args, lse, causal=True))
        torch.cuda.synchronize()
        assert bwd.launches == before[0] + 1
        assert bwd.route_launches == {
            r: n + (r == path) for r, n in before[1].items()}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*leaves, causal=True), leaves,
                               dout)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    largest = max(w.float().abs().max() for w in want)
    for name, g, a, w in zip("qkv", *got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g.view(bits), a.view(bits)), name
        scale = w.float().abs().max()
        err = (g.float() - w.float()).abs().max() / (
            scale if scale > 0 else largest)
        assert err <= TOL[dtype], (name, err)
    # keys that no query sees have zero gradients
    assert not got[0][1][:, :, Sq:].any() and not got[0][2][:, :, Sq:].any()


def test_flash_backward_resources_are_what_the_kernels_get(cuda):
    """Registers, shared memory and resident blocks of each backward
    kernel, from the card: the simt kernel keeps 16 warps an SM at DP = 64
    and 128, the wgmma kernel one block of 12 warps."""
    from repro_torch.kernels import flash_attention as fa
    for dtype, D, aligned in ((torch.float32, 64, True),
                              (torch.float32, 128, True),
                              (torch.float32, 72, False),
                              (torch.bfloat16, 20, True),
                              (torch.bfloat16, 64, True),
                              (torch.bfloat16, 128, True)):
        res = fa.backward_resources(dtype, D, aligned=aligned)
        assert res["route"] == fa.route(dtype, D, aligned=aligned)
        assert res["blocks_per_sm"] >= 1 and 0 < res["registers"] <= 255
        assert res["smem_bytes"] <= 232448
        if res["route"] == "simt":
            assert res["warps_per_sm"] >= 16, res
        else:
            assert res["warps_per_sm"] == 12, res


def test_flash_backward_with_no_keys_or_queries_gives_zeros(cuda):
    from repro_torch.kernels import flash_attention as fa
    for Sq, Sk in ((5, 0), (0, 7)):
        q, k, v = _attn_inputs(cuda, 1, 4, 2, Sq, Sk, 32, torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        if Sq:
            assert bool((lse == float("-inf")).all())
        before = fa.flash_attention_backward.launches
        grads = fa.flash_attention_backward(q, k, v, out, torch.ones_like(q),
                                            lse, causal=False)
        assert fa.flash_attention_backward.launches == before
        assert all(g.shape == t.shape and not g.any()
                   for g, t in zip(grads, (q, k, v)))


def test_flash_backward_does_not_fall_back_when_the_library_fails(
        cuda, monkeypatch):
    """A CUDA-tensor backward whose kernel library cannot be had raises;
    the plain backward is never run in its place."""
    from repro_torch.kernels import _build, flash_attention as fa, ops
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        cuda, 1, 4, 2, 64, 64, 64, torch.bfloat16))
    out = ops.flash_attention(q, k, v)

    def broken():
        raise RuntimeError("the kernel library failed to build")

    def plain(*args, **kwargs):
        raise AssertionError("the plain backward ran on the card")
    monkeypatch.setattr(_build, "library", broken)
    monkeypatch.setattr(fa, "attention_backward", plain)
    with pytest.raises(RuntimeError, match="failed to build"):
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))


def test_flash_backward_wrapper_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 4, 2, 16, 16, 32, torch.float32)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, out, lse.double(),
                                    causal=True)
    with pytest.raises(TypeError):
        fa.flash_attention_backward(q, k, v, out.bfloat16(), out, lse,
                                    causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, out, out.cpu(), lse,
                                    causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, out,
                                    out.transpose(2, 3).contiguous()
                                    .transpose(2, 3), lse, causal=True)


def test_kernel_wrappers_refuse_a_gradient_on_the_card(cuda):
    from repro_torch.kernels import flash_attention as fa, matmul as mm, ops
    from repro_torch.kernels import ssm_scan as scan
    x = torch.ones(8, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        mm.matmul(x, x)
    q = torch.ones(1, 2, 4, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(q, q, q)
    xs = torch.ones(1, 3, 4, device=cuda, requires_grad=True)
    bc = torch.ones(1, 3, 2, device=cuda)
    A = -torch.ones(4, 2, device=cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        scan.ssm_scan(xs, xs, bc, bc, A)
    # ops.ssm_scan differentiates through SSMScan: both kernels launch
    before = (scan.ssm_scan.launches, scan.ssm_scan_backward.launches)
    y = ops.ssm_scan(xs, xs, bc, bc, A)
    assert type(y.grad_fn).__name__ == "SSMScanBackward"
    (g,) = torch.autograd.grad(y.sum(), xs)
    torch.cuda.synchronize()
    assert g.shape == xs.shape and bool(torch.isfinite(g).all())
    assert (scan.ssm_scan.launches, scan.ssm_scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        assert torch.equal(mm.matmul(x, x), torch.full((8, 8), 8.0,
                                                       device=cuda))


@pytest.mark.parametrize("arch", ["qwen2-7b", "falcon-mamba-7b",
                                  "whisper-tiny", "llava-next-34b"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_reduced_train_step_kernel_matches_ref(cuda, compute_dtype, arch):
    """The reduced model's loss and gradients on the card with the kernels'
    Functions and with the plain versions (qwen2-7b, llava-next-34b with
    patch embeddings and whisper-tiny with frames: the flash Function;
    falcon-mamba-7b: SSMScan, the scan kernel forward and its backward
    kernel): float32 within 1e-4 of each leaf's largest entry; bf16 compute
    within 1e-2 of the loss and a gradient cosine of 0.99.  The key bias
    of a model without RoPE (whisper's) has the exact gradient 0, so it is
    noise in both and not compared; nor is it in bf16.  Under selective
    remat each layer's kernel forward runs twice (forward and recompute)
    and the backward kernel once; the encoder-decoder has no remat: one
    flash forward and one backward an encoder layer, two a decoder
    layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as scan
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import model_module
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_flatten_with_paths
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype=compute_dtype)
    M = model_module(cfg)
    params = M.init_params(cfg, 0, cuda)
    b = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=0).batch_at(0)
    batch = add_frontend({k: torch.as_tensor(v, device=cuda)
                          for k, v in b.items()}, cfg, 2, cuda)
    counters = ((fa.flash_attention, fa.flash_attention_backward)
                if arch != "falcon-mamba-7b"
                else (scan.ssm_scan, scan.ssm_scan_backward))
    per_step = ((cfg.n_enc_layers + 2 * cfg.n_layers,) * 2
                if cfg.is_encoder_decoder else
                (2 * cfg.n_layers, cfg.n_layers))
    out = {}
    for impl in ("kernel", "ref"):
        before = [c.launches for c in counters]
        (loss, _), grads = TF.value_and_grad(M.make_loss_fn(
            cfg, impl=impl))(params, batch)
        out[impl] = (loss.item(), dict(tree_flatten_with_paths(grads)))
        assert [c.launches - n for c, n in zip(counters, before)] == (
            list(per_step) if impl == "kernel" else [0] * len(counters))
    (lk, gk), (lr, gr) = out["kernel"], out["ref"]
    if compute_dtype == "float32":
        assert lk == pytest.approx(lr, rel=1e-5)
        for path, g in gk.items():
            if path.endswith("/bk") and not cfg.use_rope:
                continue
            err = (g - gr[path]).abs().max() / gr[path].abs().max()
            assert err <= 1e-4, (path, err)
    else:
        assert lk == pytest.approx(lr, rel=1e-2)
        for path, g in gk.items():
            if path.endswith("/bk"):
                continue
            cos = torch.nn.functional.cosine_similarity(
                g.flatten(), gr[path].flatten(), dim=0)
            assert cos >= 0.99, (path, cos)


def test_train_launcher_show_graph_on_spawned_workers(cuda):
    """``python -m repro_torch.launch.train`` on the card with
    ``--show-graph --backend process``: CUDA is initialised by then, so the
    worker spawns, rebuilds the reduced runtime from the recipe on the
    card, and its step loss equals the loop's step-0 loss."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-7b", "--reduced", "--device", "cuda", "--steps", "1",
         "--batch", "2", "--seq", "16", "--show-graph", "--backend",
         "process", "--graph-workers", "1", "--log-every", "1"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    traced = float(out.split("traced-driver step loss:")[1].split()[0])
    step0 = float(out.split("step     0 loss")[1].split()[0])
    assert traced == pytest.approx(step0, rel=1e-4)


def test_mesh_executor_runs_the_fig2_dag_on_a_world_of_one(cuda, tmp_path):
    """Phase 15a at a small size: the Fig. 2 DAG through ``MeshExecutor`` on
    a (1, 1) mesh of one NCCL rank equals the sequential oracle bit for
    bit, with one matmul launch a ``mul`` on the route ``route()`` gives,
    on each rank's local shard, and no collective."""
    from repro_torch.core import (MeshExecutor, ValueInfo,
                                  execute_sequential, standard_rules, trace)
    from repro_torch.kernels import matmul as mm
    from repro_torch.parallel.mesh import (destroy_world, init_world,
                                           make_mesh_for)
    from repro_torch.workloads import matrix_driver
    init_world(0, 1, str(tmp_path / "store"), device="cuda")
    try:
        graph, _ = trace(matrix_driver, 4, 256, device="cuda")
        want = execute_sequential(graph)[graph.outputs[0]]
        info = {t: ValueInfo((256, 256), 4, ("batch", "d_model"))
                for t in graph.nodes}
        ex = MeshExecutor(graph, make_mesh_for(1),
                          standard_rules("dp_tp", pod_axis=None),
                          value_info=info)
        before = dict(mm.matmul.route_launches)
        got = ex({})[0]
        torch.cuda.synchronize()
        path = mm.route(torch.float32, 256, 256)
        assert mm.matmul.route_launches[path] - before[path] == 4
        assert got == want
        assert ex.cost_analysis()["collectives"] == 0
        assert ex.cost_analysis()["flops"] == 4 * 2 * 256 ** 3
    finally:
        destroy_world()
