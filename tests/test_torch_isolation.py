"""The port stands alone: no module of ``repro_torch``, none of
``chip_smoke.py``, ``kernel_ab.py``, ``train_check_causes.py`` and the
``*_causes.py`` kernel studies, and no
``examples/torch_*.py`` imports JAX or the JAX package
``repro`` (by an import statement or by ``importlib.import_module``), and
neither a spawned cluster worker, a gateway client that sends it a traced
serve request, nor training the encoder-decoder and the VLM (through
``models.encdec`` and ``models.frontends``), nor a spawned gloo rank that
runs ``MeshExecutor``, loads them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), ",".join(bad))
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1) \
        if " " in proc.stdout.strip() else (proc.stdout.strip(), "")
    assert int(count) >= 64          # every module of the slices was imported
    assert bad == "", f"port imports pulled in {bad}"


_SPAWN_SCRIPT = r"""
import multiprocessing as mp
import sys


def child(q):
    import repro_torch.cluster.worker  # noqa: F401
    q.put(sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro.")))


if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=child, args=(q,))
    p.start()
    bad = q.get(timeout=120)
    p.join(timeout=60)
    print(p.exitcode, ",".join(bad))
"""


def test_a_spawned_cluster_worker_loads_no_jax_and_no_repro(tmp_path):
    """What a spawned worker of the port's cluster runtime imports: the
    worker module and its dependencies, never JAX or the JAX package."""
    script = tmp_path / "spawn_worker.py"
    script.write_text(_SPAWN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=180)
    assert proc.returncode == 0, proc.stderr
    code, _, bad = proc.stdout.strip().partition(" ")
    assert code == "0" and bad == "", proc.stdout


_NO_MESH_SCRIPT = r"""
import sys
import torch
import repro_torch.cluster.worker  # noqa: F401
import repro_torch.core  # noqa: F401
import repro_torch.parallel  # noqa: F401
from repro_torch.kernels import ops
from repro_torch.launch import serve, train  # noqa: F401
x = torch.ones((8, 8))
assert torch.equal(ops.matmul(x, x), torch.full((8, 8), 8.0))
print(",".join(sorted(m for m in ("torch.distributed.tensor",
                                  "torch.utils.flop_counter")
                      if m in sys.modules)))
"""


def test_a_process_that_runs_no_mesh_loads_no_dtensor_machinery():
    """A cluster worker, the launchers and a plain matmul import neither
    DTensor nor the FLOP counter: ``MeshExecutor`` is exported lazily and
    the placement helpers import ``torch.distributed.tensor`` when called,
    so a worker's start-up pays for none of it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_MESH_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


_BAD_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))"
    r"|import_module\(\s*[\"'](?:jax|repro)\b(?!_)", re.MULTILINE)


def test_port_sources_name_no_jax_or_repro_import():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    scripts = [ROOT / name for name in ("chip_smoke.py", "kernel_ab.py",
                                        "train_check_causes.py",
                                        "flash_fwd_causes.py",
                                        "scan_bwd_causes.py",
                                        "matmul_causes.py")]
    files = sorted(PORT.rglob("*.py")) + scripts + examples
    assert len(files) >= 70          # the modules, the scripts, the examples
    offenders = {str(f.relative_to(ROOT)): _BAD_IMPORT.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_import_pattern_catches_what_it_should():
    for src in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "    from repro.core import task", "import repro",
                "from repro import kernels",
                'importlib.import_module("repro.launch.serve")',
                "import_module('jax')"):
        assert _BAD_IMPORT.search(src), src
    for src in ("import repro_torch", "from repro_torch.core import task",
                "from .core import task", "# see repro.core.graph",
                'importlib.import_module("repro_torch.launch.serve")'):
        assert not _BAD_IMPORT.search(src), src


_GATEWAY_SERVE_SCRIPT = r"""
import sys
from repro_torch.config import ClusterConfig
from repro_torch.gateway import GatewayService
from repro_torch.launch import serve

with GatewayService(ClusterConfig(n_workers=1, token="t",
                                  progress_timeout=30.0)) as gw:
    out = serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                      "cpu", "--requests", "1", "--slots", "1",
                      "--max-new", "3", "--show-graph", "--gateway",
                      gw.address, "--gateway-token", "t"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("TOKENS", out["traced_tokens"], "BAD", ",".join(bad))
"""


def test_a_gateway_serve_request_loads_no_jax_and_no_repro():
    """``serve --gateway`` re-imports its recipe functions by module name
    before it traces: a process that runs the gateway, the client and the
    request loads neither JAX nor the JAX package.  A failure reports the
    subprocess's exit code and the ends of its output and errors."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        proc = subprocess.run([sys.executable, "-c", _GATEWAY_SERVE_SCRIPT],
                              capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=180)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"no end within 180 s\nstdout: {e.stdout!r}"
                    f"\nstderr: {e.stderr!r}")
    said = (f"rc {proc.returncode}\nstdout: {proc.stdout[-3000:]}"
            f"\nstderr: {proc.stderr[-6000:]}")
    assert proc.returncode == 0, said
    tokens, _, bad = proc.stdout.strip().splitlines()[-1].partition(" BAD")
    assert tokens.startswith("TOKENS [") and bad.strip() == "", said


_TRAIN_SCRIPT = r"""
import sys
from repro_torch.launch import train
from repro_torch.models import encdec, frontends  # noqa: F401
losses = []
for arch in ("whisper-tiny", "llava-next-34b"):
    losses += train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "16"]
                         )["losses"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("LOSSES", len(losses), "BAD", ",".join(bad))
"""


def test_training_the_encoder_decoder_and_the_vlm_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=180)
    assert proc.returncode == 0, proc.stderr
    losses, _, bad = proc.stdout.strip().splitlines()[-1].partition(" BAD")
    assert losses == "LOSSES 2" and bad.strip() == "", proc.stdout


_ONE_DEVICE_TRAIN_SCRIPT = r"""
import sys
from repro_torch.launch import train
losses = train.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "16",
                     "--remat", "none"])["losses"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro.")
             or m == "torch.distributed.tensor")
print("LOSSES", len(losses), "BAD", ",".join(bad))
"""


def test_one_device_training_loads_no_jax_no_repro_and_no_dtensor():
    """The training launcher without a world (one device) runs on plain
    tensors: it loads neither JAX, the JAX package nor
    ``torch.distributed.tensor``.  ``--remat none``: the selective remat
    policy's ``torch.utils.checkpoint`` imports ``torch._dynamo``, which
    imports FSDP and with it DTensor (torch's own import, not the
    port's)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _ONE_DEVICE_TRAIN_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=180)
    assert proc.returncode == 0, proc.stderr
    losses, _, bad = proc.stdout.strip().splitlines()[-1].partition(" BAD")
    assert losses == "LOSSES 2" and bad.strip() == "", proc.stdout


@pytest.mark.parametrize("module", ["repro_torch.models.layers",
                                    "repro_torch.models.ssm",
                                    "repro_torch.optim",
                                    "repro_torch.checkpoint.store"])
def test_a_model_module_imported_first_imports(module):
    """The model, optimizer and checkpoint modules use
    ``parallel.sharding``, whose package's pipeline runs the model's layer
    stack: imported first in a fresh process, each must not meet that
    cycle half-initialised (``parallel/pipeline.py`` imports the
    transformer when called)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr


_MESH_RANK_SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)
from repro_torch.core import MeshExecutor, ValueInfo, standard_rules, trace
from repro_torch.parallel.mesh import destroy_world, init_world, make_mesh_for
from repro_torch.workloads import matrix_driver

init_world(device="cpu")
graph, _ = trace(matrix_driver, 2, 16, device="cpu")
info = {t: ValueInfo((16, 16), 4, ("batch", "d_model")) for t in graph.nodes}
ex = MeshExecutor(graph, make_mesh_for(1, device="cpu"),
                  standard_rules("dp_tp", pod_axis=None), value_info=info)
out = ex({})[0]
destroy_world()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("OUT", out, "BAD", ",".join(bad))
"""


def test_a_spawned_gloo_rank_running_the_mesh_executor_loads_no_jax(
        tmp_path):
    """A rank of a world of one, started by ``parallel.mesh.spawn_world``,
    lowers the Fig. 2 DAG onto its (1, 1) mesh with ``MeshExecutor``: it
    imports the port's SPMD layer and ``torch.distributed``, never JAX or
    the JAX package."""
    from repro_torch.parallel.mesh import spawn_world
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, = spawn_world(["-c", _MESH_RANK_SCRIPT], 1, timeout_s=120.0,
                       env=env, cwd=str(ROOT), workdir=str(tmp_path))
    value, _, bad = out.strip().splitlines()[-1].partition(" BAD")
    assert value.startswith("OUT ") and bad.strip() == "", out
