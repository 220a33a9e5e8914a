"""The port's serve launcher on the CPU against the JAX package's.

The JAX launcher draws its parameters with
``TF.init_params(cfg, jax.random.PRNGKey(seed))``; the test draws the same
tree, carries it across with ``params_from_numpy`` and hands it to the
port's ``main`` through its ``params`` keyword, so both serve the same
model on the same argv (plus ``--device cpu``).  Greedy tokens must be
equal: both compute in float32 and differ only in summation order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ssm_scan as pt_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGV = ["--arch", "falcon-mamba-7b", "--reduced", "--requests", "3",
        "--slots", "2", "--max-new", "5", "--show-graph",
        "--backend", "thread"]


@pytest.fixture(scope="module")
def both_runs():
    want = jax_serve.main(ARGV)
    tree = JTF.init_params(jax_config("falcon-mamba-7b").reduced(),
                           jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(tree), "cpu")
    got = serve.main(ARGV + ["--device", "cpu"], params=params)
    return want, got


def test_request_tokens_equal_the_jax_launchers(both_runs):
    want, got = both_runs
    assert got["decode_steps"] == want["decode_steps"] == 12
    assert {r.rid: r.out for r in got["finished"]} == \
        {r.rid: r.out for r in want["finished"]}
    assert got["forwards"] == 3 + 3 + 12      # traced + prefills + decodes
    assert got["device"] == "cpu"


def test_traced_tokens_prefix_request_0(both_runs):
    _, got = both_runs
    req0 = next(r for r in got["finished"] if r.rid == 0)
    assert got["traced_tokens"] == req0.out[:3]


def test_serves_on_the_cpu_without_kernel_launches():
    before = pt_scan.ssm_scan.launches
    out = serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                      "cpu", "--requests", "2", "--slots", "1",
                      "--max-new", "3"])
    assert len(out["finished"]) == 2 and out["decode_steps"] == 4
    assert pt_scan.ssm_scan.launches == before


def test_dense_arch_raises_naming_the_dense_slice():
    with pytest.raises(NotImplementedError, match="dense transformer slice"):
        serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--backend", "process"],
                                   ["--transport", "tcp"],
                                   ["--fuse", "auto"]])
def test_cluster_runtime_raises_naming_roadmap_item_3(extra):
    with pytest.raises(NotImplementedError, match="§1 item 3"):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                    "cpu", "--show-graph", *extra])


def test_gateway_raises_naming_roadmap_item_4():
    with pytest.raises(NotImplementedError, match="§1 item 4"):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                    "cpu", "--gateway", "localhost:1"])


def test_without_a_card_serving_raises_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced"])
