"""The port's serve launcher on the CPU against the JAX package's.

The JAX launcher draws its parameters with
``TF.init_params(cfg, jax.random.PRNGKey(seed))``; the test draws the same
tree, carries it across with ``params_from_numpy`` and hands it to the
port's ``main`` through its ``params`` keyword, so both serve the same
model on the same argv (plus ``--device cpu``), for the Mamba1 family
(falcon-mamba-7b) and the dense family (qwen2-7b).  Greedy tokens must be
equal: both compute in float32 and differ only in summation order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as pt_flash  # noqa: E402
from repro_torch.kernels import ssm_scan as pt_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGS = ["--reduced", "--requests", "3", "--slots", "2", "--max-new", "5",
        "--show-graph", "--backend", "thread"]


def _both(arch):
    argv = ["--arch", arch] + ARGS
    want = jax_serve.main(argv)
    tree = JTF.init_params(jax_config(arch).reduced(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(tree), "cpu")
    got = serve.main(argv + ["--device", "cpu"], params=params)
    return want, got


@pytest.fixture(scope="module")
def both_runs():
    return _both("falcon-mamba-7b")


@pytest.fixture(scope="module")
def dense_runs():
    return _both("qwen2-7b")


def test_request_tokens_equal_the_jax_launchers(both_runs):
    want, got = both_runs
    assert got["decode_steps"] == want["decode_steps"] == 12
    assert {r.rid: r.out for r in got["finished"]} == \
        {r.rid: r.out for r in want["finished"]}
    assert got["forwards"] == 3 + 3 + 12      # traced + prefills + decodes
    assert got["prefills"] == 1 + 3
    assert got["device"] == "cpu"


def test_traced_tokens_prefix_request_0(both_runs):
    _, got = both_runs
    req0 = next(r for r in got["finished"] if r.rid == 0)
    assert got["traced_tokens"] == req0.out[:3]


def test_dense_request_tokens_equal_the_jax_launchers(dense_runs):
    test_request_tokens_equal_the_jax_launchers(dense_runs)


def test_dense_traced_tokens_prefix_request_0(dense_runs):
    test_traced_tokens_prefix_request_0(dense_runs)


def test_serves_on_the_cpu_without_kernel_launches():
    before = pt_scan.ssm_scan.launches
    out = serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                      "cpu", "--requests", "2", "--slots", "1",
                      "--max-new", "3"])
    assert len(out["finished"]) == 2 and out["decode_steps"] == 4
    assert pt_scan.ssm_scan.launches == before


def test_dense_arch_serves_on_the_cpu_without_kernel_launches():
    before = (pt_flash.flash_attention.launches, pt_scan.ssm_scan.launches)
    out = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--requests", "2", "--slots", "1", "--max-new", "3"])
    assert len(out["finished"]) == 2 and out["decode_steps"] == 4
    assert out["prefills"] == 2
    assert (pt_flash.flash_attention.launches,
            pt_scan.ssm_scan.launches) == before


@pytest.mark.parametrize("tp", ["1", "2"])
def test_serve_takes_the_references_tp_flag(tp):
    """The reference's ``--tp`` (``repro/launch/serve.py:114``): ``--tp 1``,
    its default, serves as before; more ways raise, naming the item that
    brings intra-op SPMD, as the training launcher does."""
    argv = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--requests", "1", "--max-new", "2"]
    if tp == "1":
        got = serve.main(argv + ["--tp", tp])
        want = serve.main(argv)
        assert len(got["finished"]) == 1
        assert [r.out for r in got["finished"]] == \
            [r.out for r in want["finished"]]
    else:
        with pytest.raises(NotImplementedError, match="item 8"):
            serve.main(argv + ["--tp", tp])


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_unported_arch_raises_naming_roadmap_item_7(arch):
    with pytest.raises(NotImplementedError, match="§1 item 7"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--backend", "process"],
                                   ["--backend", "process",
                                    "--transport", "tcp"],
                                   ["--fuse", "auto"]])
def test_cluster_runtime_raises_naming_roadmap_item_3(extra):
    """The cluster runtime's flags now run (ROADMAP §1 item 3 is done):
    the traced request, on worker processes that draw their own parameters
    from the seed, gives a prefix of request 0's tokens."""
    out = serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                      "cpu", "--requests", "2", "--slots", "1",
                      "--max-new", "4", "--graph-workers", "2",
                      "--show-graph", *extra])
    req0 = min(out["finished"], key=lambda r: r.rid)
    assert len(out["traced_tokens"]) == 3
    assert out["traced_tokens"] == req0.out[:3]
    if "process" in extra:
        # the workers ran the 3 forwards, on the CPU with no kernel launch
        stats = out["graph_stats"]
        assert {k: stats["tasks_run"][k] for k in (
            "prefill", "decode", "respond")} == {"prefill": 1, "decode": 2,
                                                 "respond": 1}
        assert stats["kernel_launches"] == {}


def test_process_backend_refuses_a_parameter_tree_it_cannot_rebuild():
    cfg = serve.get_config("falcon-mamba-7b").reduced()
    params = serve.TF.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="thread backend"):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                    "cpu", "--show-graph", "--backend", "process"],
                   params=params)


def test_gateway_raises_naming_roadmap_item_4():
    """The gateway is ported (ROADMAP §1 item 4 is done): ``--gateway``
    sends the traced request to a resident pool, whose worker draws the
    model from the seed, and gives a prefix of request 0's tokens."""
    from repro_torch.config import ClusterConfig
    from repro_torch.gateway import GatewayService
    with GatewayService(ClusterConfig(n_workers=1, token="t",
                                      progress_timeout=15.0)) as gw:
        out = serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                          "--device", "cpu", "--requests", "2", "--slots",
                          "1", "--max-new", "4", "--show-graph",
                          "--gateway", gw.address, "--gateway-token", "t",
                          "--tenant", "serve"])
    req0 = min(out["finished"], key=lambda r: r.rid)
    assert len(out["traced_tokens"]) == 3
    assert out["traced_tokens"] == req0.out[:3]
    assert out["graph_stats"]["tenant"] == "serve"
    assert out["graph_stats"]["tasks_run"]["decode"] == 2


def test_without_a_card_serving_raises_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced"])
