"""repro_torch.cluster — multi-process distributed runtime for TaskGraphs.

Port of ``repro/cluster/__init__.py``.  The port's own parts, each named in
its module's docstring: tensors cross the data plane as host bytes through
pickle-5 buffers (``serde.py``); forked workers compute on one CPU thread
and must not touch CUDA, so once the driver has initialised CUDA the
executor starts its workers with ``spawn`` unless the config names a start
method (``executor.py``); workers report their kernel launches with each
``done`` (``worker.py``); the executor reports ``first_done_s``,
``last_done_s`` and ``kernel_launches`` (``executor.py``).

Backend choice (also see ROADMAP.md §runtime backends):

* ``thread`` (:class:`repro_torch.core.executor.ThreadedExecutor`) — one process,
  work-stealing threads.  Zero serialization, shared memory; real speedups
  only when task payloads release the GIL (asynchronous CUDA launches, the
  kernels' ctypes calls, numpy's bulk draws).  No fault
  isolation: a crashing task kills the run.
* ``process`` (:class:`ClusterExecutor`, here) — driver + forked OS-process
  workers over pipes.  True parallelism for Python-level work, per-worker
  object stores, and real fault tolerance: a SIGKILL'd worker triggers
  lineage recovery (recompute exactly the lost results) plus an elastic
  replan onto the survivors.

The **data plane** is zero-copy (:mod:`repro_torch.cluster.serde`): cross-worker
values move as handles — payload buffers are published once into
``multiprocessing.shared_memory`` segments (or pulled over a per-worker
unix socket when shm is unavailable) and mapped directly by the consumer,
so the driver pipe carries only control messages.  The
``transport={"auto","shm","sock","driver"}`` knob selects the channel
(``driver`` restores the PR-1 relay for A/B benchmarks), and the
``stats`` fields ``bytes_moved`` / ``bytes_driver`` / ``bytes_direct`` /
``transfers_direct`` / ``transfers_driver`` make the split observable.
Dispatch is **locality-aware**: per-value sizes recorded at completion
drive both the scheduler's comm-cost term and a transfer-cost score in the
driver's stealing loop, so consumers land on the worker already holding
the largest share of their input bytes — with per-host grouping, so a
same-host shm move is preferred over a cross-host TCP pull.

The **driver hot path is compiled, not interpreted**: a plan-time fusion
pass (:mod:`repro_torch.core.fusion`, ``fuse={"off","auto",N}``) clusters the
task graph into super-tasks — one control message dispatches a whole
chain/fan-in/sibling group, members execute inside one worker frame, and
only cluster-boundary values touch the object store — while outgoing
control messages coalesce into per-worker batch frames
(``Channel.send_many``), amortizing pickle + syscall cost under load.
``stats`` exposes the win directly: ``n_clusters`` / ``tasks_fused`` /
``control_msgs`` / ``control_frames`` / ``dispatch_overhead_s``.  See
``docs/fusion.md``.

The **control plane** is an explicit channel layer
(:mod:`repro_torch.cluster.channel`): the driver speaks the same tuple protocol
over forked duplex pipes (``channel="pipe"``), spawned fresh-interpreter
pipes (``"spawn"``), or a length-prefixed framed TCP stream (``"tcp"``)
that workers on any host dial into (``python -m repro_torch.launch.remote
--connect <driver address>``).  TCP liveness is heartbeat-based — socket
death delivers no SIGCHLD — with an explicit goodbye distinguishing clean
shutdown from a crash, and sends ride backpressure-bounded queues so a
wedged peer reads as dead instead of wedging the driver.

Both executors satisfy the :class:`repro_torch.core.executor.Executor` protocol
and are differentially tested against ``execute_sequential`` (tasks are
pure, so every backend must agree bit-for-bit), including under SIGKILL
mid-run and mid-transfer, over every channel and transport.

Public API: :class:`ClusterExecutor`, :class:`ClusterFuture`,
:func:`gather`, :class:`DriverObjectStore`, :mod:`repro_torch.cluster.serde`,
:mod:`repro_torch.cluster.channel`.
"""
from . import channel, serde
from .executor import ClusterExecutor, DriverKilled
from .futures import ClusterFuture, gather
from .objectstore import DriverObjectStore

__all__ = ["ClusterExecutor", "ClusterFuture", "gather", "DriverKilled",
           "DriverObjectStore", "serde", "channel"]
