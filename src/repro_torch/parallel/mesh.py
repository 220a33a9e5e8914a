"""Device meshes over a ``torch.distributed`` world, and the world itself.

Port of ``repro/parallel/mesh.py`` (``_make`` :34-47,
``make_production_mesh`` :50, ``make_mesh_for`` :58,
``single_device_mesh`` :68).  The reference lays a ``jax.sharding.Mesh``
over the devices of one process; here every device is one rank of a
``torch.distributed`` world (NCCL for the card, gloo for the CPU), and a
:class:`Mesh` names the axes of a ``DeviceMesh`` over the world's first
ranks.  A mesh of one device needs no world: it describes that device under
the rule tables' axis names, as the launchers use it.

Importing this module initialises no process group and touches no device.
:func:`init_world` joins a process to a world (rank, size, a file
rendezvous, the backend its device names); :func:`spawn_world` starts one
of N local processes, each a rank, with a hard time limit.  One card gives
a world of one, so meshes of more devices are held to the reference on N
gloo ranks on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..interop import Device, resolve_device

# the environment a rank started by spawn_world reads in init_world
RANK_ENV, WORLD_ENV, STORE_ENV = "RANK", "WORLD_SIZE", "REPRO_WORLD_STORE"
# how long a collective waits for its peers before it raises
COLLECTIVE_TIMEOUT = timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes over ``device``: this rank's device,
    in ``device_mesh`` (a ``torch.distributed`` ``DeviceMesh``, ``None``
    for a mesh of one device made without a world)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name to size, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis: str):
        """The process group of this rank's peers along ``axis``."""
        return self._device_mesh().get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        if self.shape[axis] == 1:
            return 0
        return self._device_mesh().get_local_rank(axis)

    def _device_mesh(self):
        if self.device_mesh is None:
            raise ValueError("this mesh has no world: start one with "
                             "parallel.mesh.init_world first")
        return self.device_mesh


def world_size() -> int:
    """The initialised world's size, or 1 without a world."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_world(rank: Optional[int] = None, size: Optional[int] = None,
               store: Optional[str] = None,
               device: Optional[Device] = None) -> str:
    """Join this process to a world as rank ``rank`` of ``size``, meeting
    the others through the file ``store`` (a ``file://`` rendezvous, made
    fresh for each world).  Each argument left out is read from the
    environment :func:`spawn_world` sets (``RANK``, ``WORLD_SIZE``,
    ``REPRO_WORLD_STORE``).  The backend is the one ``device`` names (the
    card unless another is named): NCCL for CUDA, each rank on card
    ``rank % device_count``; gloo for the CPU.  Returns the backend."""
    rank = int(os.environ[RANK_ENV]) if rank is None else rank
    size = int(os.environ[WORLD_ENV]) if size is None else size
    store = os.environ[STORE_ENV] if store is None else store
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=size,
                            timeout=COLLECTIVE_TIMEOUT)
    return backend


def destroy_world() -> None:
    """Leave the world, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_world(argv: Sequence[str], n: int, *, timeout_s: float = 240.0,
                env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None,
                workdir: Optional[str] = None) -> List[str]:
    """Run ``python argv...`` as ``n`` local processes, the ranks of one
    world, and return each rank's standard output.

    Each rank finds its rank, the world's size and a fresh rendezvous file
    in its environment (read by :func:`init_world`), with
    ``OMP_NUM_THREADS=1``.  Their output goes to files under ``workdir``
    (a new temporary directory unless given).  If the ranks have not all
    ended after ``timeout_s`` seconds, all are killed and ``TimeoutError``
    is raised; a rank that exits non-zero raises ``RuntimeError`` with the
    end of its errors."""
    work = Path(workdir or tempfile.mkdtemp(prefix="repro-world-"))
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    base = dict(os.environ if env is None else env)
    base.update({WORLD_ENV: str(n), STORE_ENV: str(store),
                 "OMP_NUM_THREADS": "1"})
    procs, files = [], []
    try:
        for rank in range(n):
            files.append((open(work / f"rank{rank}.out", "w+"),
                          open(work / f"rank{rank}.err", "w+")))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=files[-1][0],
                stderr=files[-1][1], cwd=cwd,
                env=dict(base, **{RANK_ENV: str(rank)})))
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                f"a world of {n} ranks did not end within {timeout_s} s; "
                f"every rank was killed:\n{_tails(files)}") from None
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of {n} exited with "
                                   f"{p.returncode}:\n{_tails(files)}")
        outputs = []
        for out, _ in files:
            out.seek(0)
            outputs.append(out.read())
        return outputs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()


def _tails(files, n: int = 2000) -> str:
    parts = []
    for rank, (_, err) in enumerate(files):
        err.flush()
        err.seek(0)
        text = err.read()[-n:]
        if text:
            parts.append(f"--- rank {rank} ---\n{text}")
    return "\n".join(parts)


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device: Optional[Device] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: over the world's first
    ``prod(shape)`` ranks when a world is initialised (a rank past them
    holds a mesh it has no coordinate in, as the reference's dry-run world
    takes a prefix of its devices), else over one device."""
    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise ValueError(f"need {n} devices for mesh {shape}, have {have}")
    if not dist.is_initialized():
        return Mesh(tuple(axes), tuple(shape), resolve_device(device))
    from torch.distributed.device_mesh import DeviceMesh
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ranks = torch.arange(n).reshape(shape)
    return Mesh(tuple(axes), tuple(shape), dev,
                DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Device] = None) -> Mesh:
    """The reference's production mesh: (16, 16) over (data, model); two
    pods (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device)


def make_mesh_for(n_devices: int, model_parallel: int = 1, pods: int = 1,
                  device: Optional[Device] = None) -> Mesh:
    """The reference's generic mesh builder: ``n_devices`` as (data, model)
    or, with ``pods`` > 1, (pod, data, model)."""
    if n_devices % (model_parallel * pods):
        raise ValueError(f"{n_devices} devices do not split into {pods} "
                         f"pods of model_parallel={model_parallel}")
    data = n_devices // (model_parallel * pods)
    if pods > 1:
        return _make((pods, data, model_parallel), ("pod", "data", "model"),
                     device)
    return _make((data, model_parallel), ("data", "model"), device)


def join_launcher_world(device: Optional[Device] = None) -> int:
    """The size of the ``torch.distributed`` world this process is a rank
    of, 0 when it is in none.  A process group already initialised (by the
    caller) is used as it is; else, when the environment names a world
    (``RANK``, ``WORLD_SIZE`` and ``REPRO_WORLD_STORE``, as
    :func:`spawn_world` sets them), the process joins it through
    :func:`init_world` on ``device``'s backend (NCCL for the card, gloo for
    the CPU).  The counterpart of the reference's ``len(jax.devices())``."""
    if dist.is_initialized():
        return dist.get_world_size()
    if all(k in os.environ for k in (RANK_ENV, WORLD_ENV, STORE_ENV)):
        init_world(device=device)
        return dist.get_world_size()
    return 0


def launcher_mesh(tp: int, device: Optional[Device] = None,
                  entry: str = "repro_torch.launch.train") -> Optional[Mesh]:
    """The launchers' ``(N / tp, tp)`` (data, model) mesh over the world of
    N ranks this process is in (:func:`join_launcher_world`), or ``None``
    without a world, where only ``tp == 1`` runs (on one device).  A ``tp``
    that does not divide the world, or any ``tp > 1`` without one, raises
    ``ValueError`` naming the world's size and how to start one: the
    reference ignores ``--tp`` on one device, the port does not."""
    n = join_launcher_world(device)
    how = (f"start a world of N ranks, e.g. parallel.mesh.spawn_world("
           f"['-m', '{entry}', ..., '--tp', '{tp}'], N), or set {RANK_ENV}, "
           f"{WORLD_ENV} and {STORE_ENV} in each rank's environment")
    if not n:
        if tp != 1:
            raise ValueError(f"--tp {tp} needs a torch.distributed world of "
                             f"a multiple of {tp} ranks, and this process is "
                             f"in none (a world of size 0): {how}")
        return None
    if tp < 1 or n % tp:
        raise ValueError(f"--tp {tp} does not divide the world of {n} "
                         f"ranks: {how}")
    return make_mesh_for(n, model_parallel=tp, device=device)


def single_device_mesh(device: Optional[Device] = None) -> Mesh:
    """The (1, 1) mesh over ("data", "model") on ``device`` (the card
    unless another is named)."""
    return _make((1, 1), ("data", "model"), device)
