"""Helpers shared by the port's runtime parity suites
(``tests/test_torch_{faults,speculation,collectives,multihost,runlog,
adaptive}.py``).

This module imports the port and never the JAX package: a ``python -m
repro_torch.launch.remote`` worker or a ``repro_torch.launch.driver``
process unpickles the graphs built here, so the task bodies live at module
level and their import must stay cheap.
"""
import os
import random
import time
from functools import partial

import numpy as np
import torch

from repro_torch.config import ClusterConfig
from repro_torch.core import TaskGraph, TaskKind
from repro_torch.core.tracing import RemappedRef as Ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what a worker or driver subprocess needs to import the port and this
# module's task bodies
WORKER_ENV = dict(
    os.environ,
    PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.dirname(os.path.abspath(__file__))]
        + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))


# ------------------------------------------------------------ comparisons

def same_value(a, b) -> bool:
    """Bit for bit: tensors and arrays by dtype, shape and values, tuples
    element by element, anything else by ``==``."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(map(same_value, a, b))
    return a == b


def results_equal(got, want) -> bool:
    return got.keys() == want.keys() and all(same_value(got[k], want[k])
                                             for k in want)


def as_numpy(v):
    """A port value as the reference would hold it (tensors to numpy)."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, tuple):
        return tuple(as_numpy(x) for x in v)
    return v


# ------------------------------------------------- picklable task bodies

def _mh_combine(i, *xs):
    """Module-level task body: picklable, so remote workers can import it."""
    return (i + sum(xs) * 7) % 1_000_003


def _mh_combine_slow(i, *xs):
    """Same arithmetic, padded to keep a run alive while a joiner dials."""
    time.sleep(0.03)
    return _mh_combine(i, *xs)


def picklable_dag(seed: int, n: int, p: float, slow: bool = False
                  ) -> TaskGraph:
    """DAG whose node fns survive pickling (remote-worker requirement)."""
    rng = random.Random(seed)
    fn = _mh_combine_slow if slow else _mh_combine
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]
        g.add_node(f"t{i}", partial(fn, i),
                   tuple(Ref(d) for d in deps), {},
                   TaskKind.PURE, deps=deps, cost=1.0)
    g.mark_output(n - 1)
    return g


def _dk_slow_graph():
    """Graph builder the driver-kill drill passes to
    ``repro_torch.launch.driver``: slow enough that the SIGKILL reliably
    lands mid-run."""
    return picklable_dag(9, 80, 0.3, slow=True)


# -------------------------------------------------- the Fig. 2 workload

def fig2_process_run(n_tasks: int, size: int, n_workers: int, **config):
    """The port's Fig. 2 DAG (torch tensors on the CPU, drawn from numpy)
    on ``n_workers`` forked workers; returns ``(graph, results, report)``
    and the sequential run's results."""
    from repro_torch.workloads import run_matrix_dag
    _, seq, _ = run_matrix_dag(n_tasks, size, 1, device="cpu")
    config.setdefault("progress_timeout", 30.0)
    g, got, rep = run_matrix_dag(
        n_tasks, size, n_workers, device="cpu", backend="process",
        config=ClusterConfig(n_workers=n_workers, **config))
    return g, got, rep, seq
