"""The paper's Fig. 2 workload on the port: matrix generation and
multiplication task graphs.

Counterpart of ``matrix_driver`` in ``benchmarks/matmul_scaling.py``.  Each
unit is ``gen(2i), gen(2i+1) -> mul -> reduce``:

* ``gen`` draws an ``(size, size)`` standard-normal float32 matrix with
  numpy's ``default_rng(seed)``, as the reference does, and moves it to the
  device, so both packages multiply the same matrices;
* ``mul`` is the port's matmul kernel (:func:`repro_torch.kernels.ops.matmul`);
* ``reduce`` sums each product on the device in float64 and adds the sums
  on the host in argument order, so its value is deterministic.

A graph of ``n_tasks`` units has ``3 * n_tasks + 1`` nodes (``chain > 1``
adds ``chain - 1`` multiplies per unit) and launches the kernel once per
``mul`` node.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core.executor import run_graph
from .core.graph import TaskGraph
from .core.tracing import task, trace
from .interop import Device, resolve_device, tensor_from_numpy
from .kernels import ops

# the scheduler's cost estimates of one gen and one mul (the reference
# driver takes them as arguments, calibrated on the host it runs on)
COST_GEN, COST_MUL = 1.0, 2.0


def matrix_driver(n_tasks: int, size: int, *, device: Device,
                  dtype: torch.dtype = torch.float32, chain: int = 1):
    """The paper's workload as a traced driver (see the module docstring).

    ``chain`` > 1 strings extra multiplies in sequence per unit, lowering
    max parallelism.
    """
    device = torch.device(device)
    nbytes = size * size * dtype.itemsize

    @task(cost=COST_GEN, name="gen", out_bytes=nbytes)
    def gen(seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((size, size), dtype=np.float32)
        return tensor_from_numpy(a, device).to(dtype)

    @task(cost=COST_MUL, name="mul", out_bytes=nbytes)
    def mul(a, b):
        return ops.matmul(a, b)

    @task(cost=0.0, name="reduce")
    def red(*xs):
        return sum(float(x.sum(dtype=torch.float64)) for x in xs)

    outs = []
    for i in range(n_tasks):
        a = gen(2 * i)
        b = gen(2 * i + 1)
        m = mul(a, b)
        for _ in range(chain - 1):
            m = mul(m, b)
        outs.append(m)
    return red(*outs)


def run_matrix_dag(n_tasks: int, size: int, n_workers: int, *,
                   device: Optional[Device] = None,
                   dtype: torch.dtype = torch.float32, chain: int = 1,
                   ) -> Tuple[TaskGraph, Dict[int, Any], Dict[str, Any]]:
    """Trace the Fig. 2 DAG and run it: on the sequential oracle when
    ``n_workers == 1``, else on the work-stealing ``ThreadedExecutor``.

    Runs on the card unless ``device`` names another; raises when no device
    is given and no card is present.  Returns ``(graph, results, report)``:
    every node's value by task id, and ``run_graph``'s report (backend,
    workers, wall time, stats).  The run ends with the ``reduce`` task
    reading its sums back to the host, so the wall time covers the device
    work.
    """
    device = resolve_device(device)
    graph, _ = trace(matrix_driver, n_tasks, size, device=device,
                     dtype=dtype, chain=chain)
    results, report = run_graph(graph, n_workers, with_report=True)
    return graph, results, report
