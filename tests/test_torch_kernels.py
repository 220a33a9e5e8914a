"""The port's matmul entry point on the CPU against the JAX package's Pallas
kernel (interpret mode), the port's numpy interop, and the kernel build's
orchestration (one compiler per source, started together, then one link),
run with a stand-in ``nvcc`` script since the CPU has no CUDA toolkit.

Same inputs, made from a seed with numpy, go through
``repro.kernels.ops.matmul(..., interpret=True)`` and
``repro_torch.kernels.ops.matmul`` (whose wrapper takes the plain PyTorch
version for CPU tensors).  Tolerance: ``tests/test_kernels.py``'s matmul
tolerances (2e-5 float32, 2e-2 bfloat16), applied to ``out / sqrt(K)``: the
inputs are standard normal, so products grow like ``sqrt(K)`` and the two
frameworks' different summation orders leave an error that grows with them.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.interop import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.kernels import matmul as pt_matmul  # noqa: E402
from repro_torch.kernels import ops as pt_ops, ref as pt_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    y = rng.standard_normal((K, N), dtype=np.float32)
    if dtype == "bfloat16":
        x, y = x.astype(jnp.bfloat16), y.astype(jnp.bfloat16)
    return x, y


# two shapes of test_kernels.py's matmul sweep, plus a ragged one
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 512, 128),
                                   (100, 77, 131)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(M, K, N, dtype):
    x, y = _inputs(M, K, N, dtype)
    want = np.asarray(jax_ops.matmul(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True), np.float32)
    out = pt_ops.matmul(tensor_from_numpy(x, "cpu"),
                        tensor_from_numpy(y, "cpu"))
    assert tuple(out.shape) == (M, N)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    got = np.asarray(tensor_to_numpy(out), np.float32)
    s = np.sqrt(K)
    np.testing.assert_allclose(got / s, want / s, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_ops_impls_agree_and_cpu_does_not_count_launches():
    x, y = (tensor_from_numpy(a, "cpu") for a in _inputs(64, 48, 32,
                                                          "float32"))
    before = pt_matmul.matmul.launches
    kernel = pt_ops.matmul(x, y)
    plain = pt_ops.matmul(x, y, impl="ref")
    assert torch.equal(kernel, plain)         # CPU: the wrapper IS ref
    assert pt_matmul.matmul.launches == before
    with pytest.raises(ValueError):
        pt_ops.matmul(x, y, impl="pallas")


# (dtype, N, K) -> the kernel the card runs: bf16 rows that are 16-byte
# aligned (K % 8 == 0, N % 8 == 0) go to the tensor cores; float32 never
@pytest.mark.parametrize("dtype,N,K,want", [
    (torch.bfloat16, 4096, 4096, "wgmma"),    # the bf16 main shape
    (torch.bfloat16, 1528, 776, "wgmma"),     # aligned, not a tile multiple
    (torch.bfloat16, 64, 0, "wgmma"),         # K = 0: zeros
    (torch.bfloat16, 8, 8, "wgmma"),
    (torch.bfloat16, 1531, 777, "simt"),      # neither aligned
    (torch.bfloat16, 1528, 777, "simt"),      # K % 8 != 0
    (torch.bfloat16, 1531, 776, "simt"),      # N % 8 != 0
    (torch.bfloat16, 129, 7, "simt"),
    (torch.float32, 4096, 4096, "simt"),      # Fig. 2's mul
    (torch.float32, 1528, 776, "simt"),
    (torch.float32, 64, 0, "simt")])
def test_matmul_route_follows_dtype_and_alignment(dtype, N, K, want):
    assert pt_matmul.route(dtype, N, K) == want


# a pointer off a 16-byte boundary sends every product to the CUDA cores
@pytest.mark.parametrize("dtype,N,K", [
    (torch.bfloat16, 4096, 4096), (torch.bfloat16, 1528, 776),
    (torch.bfloat16, 64, 0), (torch.bfloat16, 1531, 777),
    (torch.float32, 4096, 4096)])
def test_matmul_route_takes_misaligned_pointers_to_simt(dtype, N, K):
    assert pt_matmul.route(dtype, N, K, aligned=False) == "simt"
    assert pt_matmul.variant(dtype, N, K, aligned=False) == "scalar"


# (dtype, N, K, aligned) -> how the kernel loads its tiles: TMA for wgmma;
# 16-byte copies of y for float32 with N % 4 == 0 and aligned pointers
@pytest.mark.parametrize("dtype,N,K,aligned,want", [
    (torch.float32, 4096, 4096, True, "vector"),   # Fig. 2's mul
    (torch.float32, 1528, 776, True, "vector"),
    (torch.float32, 1528, 777, True, "vector"),    # x moves 4 B a copy
    (torch.float32, 64, 12, True, "vector"),       # K < BK
    (torch.float32, 1531, 776, True, "scalar"),    # N % 4 != 0
    (torch.float32, 1531, 777, True, "scalar"),
    (torch.float32, 1528, 776, False, "scalar"),   # misaligned pointer
    (torch.bfloat16, 1528, 776, True, "tma"),      # wgmma
    (torch.bfloat16, 1528, 776, False, "scalar"),
    (torch.bfloat16, 1532, 776, True, "scalar"),   # bf16 simt: N % 8 != 0
    (torch.bfloat16, 1531, 777, True, "scalar")])
def test_matmul_variant_follows_dtype_shape_and_alignment(dtype, N, K,
                                                          aligned, want):
    assert pt_matmul.variant(dtype, N, K, aligned=aligned) == want
    assert pt_matmul.route(dtype, N, K, aligned=aligned) == (
        "wgmma" if want == "tma" else "simt")


def test_cpu_matmul_launches_no_route():
    x, y = (tensor_from_numpy(a, "cpu") for a in _inputs(64, 48, 32,
                                                          "bfloat16"))
    assert pt_matmul.route(x.dtype, 32, 48) == "wgmma"
    before = dict(pt_matmul.matmul.route_launches)
    out = pt_ops.matmul(x, y)
    assert torch.equal(out, pt_ref.matmul(x, y))
    assert pt_matmul.matmul.route_launches == before
    assert set(before) == {"wgmma", "simt"}


@pytest.mark.parametrize("bad", ["inner", "dtype", "rank"])
def test_matmul_wrapper_rejects_bad_arguments(bad):
    x = torch.zeros(4, 3)
    y = {"inner": torch.zeros(4, 5),
         "dtype": torch.zeros(3, 5, dtype=torch.float64),
         "rank": torch.zeros(3, 5, 1)}[bad]
    with pytest.raises((ValueError, TypeError)):
        pt_matmul.matmul(x, y)


def test_ref_matmul_computes_in_float32():
    x, y = _inputs(16, 300, 8, "bfloat16", seed=3)
    out = pt_ref.matmul(tensor_from_numpy(x, "cpu"),
                        tensor_from_numpy(y, "cpu"))
    want = (np.asarray(x, np.float32) @ np.asarray(y, np.float32)
            ).astype(jnp.bfloat16)
    got = tensor_to_numpy(out)
    # one bf16 rounding of an fp32 sum on each side: at most one bf16 ulp
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=2 ** -7)


# ------------------------------------------------------------------ interop

@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32, jnp.int32])
def test_interop_round_trip_from_jax_is_bit_exact(dtype):
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal((5, 7)) * 100, dtype)
    host = np.asarray(a)                     # read-only, as JAX hands it out
    assert not host.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # torch warns on read-only memory
        t = tensor_from_numpy(host, "cpu")
    back = tensor_to_numpy(t)
    assert back.dtype == host.dtype and back.shape == host.shape
    assert back.tobytes() == host.tobytes()


def test_interop_bf16_matches_torch_cast_bits():
    x = np.random.default_rng(2).standard_normal(64, dtype=np.float32)
    via_numpy = tensor_from_numpy(x.astype(jnp.bfloat16), "cpu")
    via_torch = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(via_numpy.view(torch.int16), via_torch.view(torch.int16))


def test_interop_does_not_alias_readonly_or_strided_input():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = tensor_from_numpy(a[:, ::-1], "cpu")       # negative strides
    assert torch.equal(t, torch.tensor(a[:, ::-1].copy()))
    ro = a.copy()
    ro.flags.writeable = False
    t = tensor_from_numpy(ro, "cpu")
    t += 1
    assert ro[0, 0] == 0.0


# --------------------------------------------------------------- the build

_FAKE_NVCC = r"""#!/usr/bin/env python3
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[-1]
    with open(out + ".times", "w") as f:
        f.write(f"{time.time()}\n")
        time.sleep(1.5)
        f.write(f"{time.time()}\n")
    if src.endswith("FAIL_SRC"):
        print("error: broken source")
        sys.exit(2)
    print(f"ptxas info    : Compiling entry function 'k_{src.rsplit('/', 1)[-1]}'")
    open(out, "w").write(src)
else:
    open(out, "w").write("|".join(open(p).read() for p in args[args.index("-o") + 2:]))
"""


def _fake_build(tmp_path, monkeypatch, fail=""):
    from repro_torch.kernels import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.replace("FAIL_SRC", fail or "no-such.cu"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    out_dir = tmp_path / "out"
    return _build, out_dir


def test_build_compiles_each_source_at_once_and_links_one_library(
        tmp_path, monkeypatch):
    _build, out_dir = _fake_build(tmp_path, monkeypatch)
    _build._compile(out_dir)
    sources = [p.name for p in _build._sources() if p.suffix == ".cu"]
    assert {"matmul.cu", "ssm_scan.cu"} <= set(sources)
    log = (out_dir / "nvcc.log").read_text()
    for name in sources:
        assert f"== {name}\n" in log and f"'k_{name}'" in log
    assert sorted((out_dir / "libkernels.so").read_text().split("|")) == \
        sorted(str(p) for p in _build._sources() if p.suffix == ".cu")
    # every compile started before any one of them ended
    spans = [list(map(float, p.read_text().split()))
             for p in out_dir.glob("*.times")]
    assert len(spans) == len(sources)
    assert max(s for s, _ in spans) < min(e for _, e in spans)
    assert not list(out_dir.glob("*.o"))
    assert [p.name for p in out_dir.glob("*.log")] == ["nvcc.log"]


def test_build_failure_names_the_source_and_leaves_no_library(
        tmp_path, monkeypatch):
    _build, out_dir = _fake_build(tmp_path, monkeypatch, fail="ssm_scan.cu")
    with pytest.raises(RuntimeError, match="ssm_scan.cu"):
        _build._compile(out_dir)
    assert not (out_dir / "libkernels.so").exists()
    assert not list(out_dir.glob("*.o"))


_LOCKED_BUILD = r"""
import sys, time
from pathlib import Path
from repro_torch.kernels import _build
root, me = Path(sys.argv[1]), sys.argv[2]
_build.BUILD_ROOT = root / "build"


def fake_compile(out_dir):
    with open(root / "builds", "a") as f:
        f.write(me + "\n")
    time.sleep(1.0)              # long enough for the other to arrive
    (out_dir / "libkernels.so").write_text(me)


_build._compile = fake_compile
(root / f"ready.{me}").touch()
while not (root / "go").exists():
    time.sleep(0.01)
print(_build.ensure_built().read_text())
"""


def test_two_processes_share_one_build(tmp_path):
    """A fresh checkout's spawned workers reach ``ensure_built`` together:
    the build directory's file lock lets one build, and the other finds
    its library (``_compile`` is stubbed, so no ``nvcc`` is needed)."""
    import os
    import subprocess
    import sys
    import time
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _LOCKED_BUILD,
                               str(tmp_path), name], env=env,
                              stdout=subprocess.PIPE, text=True)
             for name in ("a", "b")]
    deadline = time.monotonic() + 60
    while not all((tmp_path / f"ready.{n}").exists() for n in "ab"):
        assert time.monotonic() < deadline, "the builders did not start"
        time.sleep(0.01)
    (tmp_path / "go").touch()
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    builds = (tmp_path / "builds").read_text().split()
    assert len(builds) == 1 and outs == builds * 2


def test_matmul_wrapper_refuses_a_gradient():
    """The kernel writes its output behind autograd's back, so a product
    of grad-requiring inputs raises (on the CPU as on the card) instead of
    returning a result with no gradient; under no_grad it computes."""
    x = torch.ones(4, 3, requires_grad=True)
    y = torch.ones(3, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        pt_matmul.matmul(x, y)
    with torch.no_grad():
        assert torch.equal(pt_matmul.matmul(x, y), torch.full((4, 2), 3.0))
    assert torch.equal(pt_matmul.matmul(x.detach(), y),
                       torch.full((4, 2), 3.0))
