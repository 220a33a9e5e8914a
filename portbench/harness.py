"""What every run of the benchmark shares: ``BENCHMARK.json`` and the files
it names, found by name; the caches kept inside the checkout; the card's
description; the check that nothing of JAX was loaded; and the result's
last line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the wall clock (``/proc``'s start time, in
    clock ticks since boot), or now where ``/proc`` has none."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def keep_caches_in_checkout() -> None:
    """Point every compiler cache the program or torch could use at fixed
    directories of the checkout (``build/`` is where the program builds
    its kernel library, ``build/repro_torch/<hash>``)."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def _json(path: str) -> Dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json("BENCHMARK.json")


def cell(bench: Dict, workload: str) -> Dict:
    """The cell ``workload`` with its configuration file's dict
    (``config``), its traffic mix (``traffic``) and the metrics it reports
    untraced (``end_to_end``) and traced (``per_layer``)."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": w, "config": _json(conf["file"]),
            "traffic": traffic(w["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def traffic(name: str) -> Dict:
    return _json(os.path.join("portbench", "traffic", f"{name}.json"))


def driver(kind: str):
    """The module that drives traffic of ``kind``: ``traffic/<kind>.py``."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def foreign_modules() -> List[str]:
    """The JAX-side packages this process has loaded, by whole top-level
    name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def card(torch) -> Dict:
    """The card's name, count and power limit (``nvidia-smi``); a run
    driven on the CPU (the tests) says so."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "nvidia_smi": "no card"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "nvidia_smi": smi}


def emit(result: Dict, checks: Dict[str, Dict],
         out=sys.stdout, err=sys.stderr) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error and under ``limits``, the result's last key; then the
    result as the last line of standard output."""
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILS'}", file=err, flush=True)
    line = dict(result, limits={n: {"value": c["value"], "limit": c["limit"]}
                                for n, c in checks.items()})
    print(json.dumps(line), file=out, flush=True)


def fail(message: str, code: int = 1) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code

