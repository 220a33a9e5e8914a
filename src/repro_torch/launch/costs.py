"""What one run of a program costs each device: FLOPs by dtype, bytes,
collectives, memory, and a log of its operations; with the H100's
constants and the kernels' bounds.

:class:`Counter` is a ``TorchDispatchMode`` that counts every operation
dispatched while it is active, as this rank runs it.  For an operation on
DTensors it counts nothing itself (it returns ``NotImplemented``, so
DTensor dispatches first) and counts the local operations, collectives
and redistributions DTensor then runs on this rank's shards: the rank's
own FLOPs and bytes, as XLA's cost analysis of a partitioned program gives
them per device.  (``torch.utils.flop_counter.FlopCounterMode`` sees the
DTensor-level call with global shapes, and so counts the whole mesh's
work on every rank.)  The dry-run (``launch/dryrun.py``),
``core/mesh_executor.py`` and ``chip_smoke.py`` count through it.

- **FLOPs**: ``torch.utils.flop_counter``'s formulas for the aten products
  (mm, bmm, addmm, convolutions, ...), and :data:`kernels.operators.FLOPS`
  for the kernels' operators, each filed under the dtype of its
  arithmetic: the card runs float32 products on its CUDA cores and bf16
  on its tensor cores, at :data:`PEAK_FLOPS` of each.  While a count runs,
  ``kernels/ops.py`` calls the kernels through their operators
  (``kernels.operator_route``), so on fake tensors, on the CPU and on the
  card the same kernels are counted the same way.
- **Bytes**: each operation reads each tensor input once and writes each
  tensor output once; views, ``expand``, allocations and other
  metadata-only operations move nothing.  That is what eager execution
  does, operation by operation.  XLA's "bytes accessed" counts after
  fusion, so the two are not the same quantity.
- **Collectives**: one event per ``_c10d_functional`` /
  ``_c10d_functional_autograd`` / ``c10d`` collective and per
  ``_dtensor.shard_dim_alltoall``: its kind in the reference's HLO names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-broadcast``), its result bytes on this rank, and its
  group's global ranks, read from the process group.
  ``launch.dryrun.parse_collectives`` turns them into wire bytes.
- **Memory**: the bytes of the live storages this rank holds: those
  registered with :meth:`Counter.hold` (the arguments) and each storage
  an operation allocates, until it is freed; the peak, and the reference's
  ``argument_size_in_bytes``, ``output_size_in_bytes``,
  ``temp_size_in_bytes`` and ``peak_memory_in_bytes`` (:meth:`memory`).
  It sees what the operations allocate; the caching allocator's rounding
  and fragmentation and the libraries' workspaces (cuBLAS) are not
  operations, and are not in it.
- **The op log** (``log=True``): one line per dispatched operation with
  its shapes, dtypes, FLOPs and bytes; a DTensor-level operation's line
  gives its global shapes and placements before the local lines it runs;
  a collective's line its kind, bytes and group (:meth:`Counter.text`).
  With ``where=True`` each line also names the model function and line
  that issued it (the port's models are functions, not ``nn.Module``s,
  so ``torch.distributed._tools.mod_tracker.ModTracker`` would see no
  module path).
"""
from __future__ import annotations

import collections
import sys
import weakref
from typing import Any, Dict, List, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import operators

# NVIDIA H100 SXM5 80GB data sheet, dense: float32 on the CUDA cores,
# bf16 (and fp16) on the tensor cores; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# torch.cuda.get_device_properties(0).total_memory on the card of
# chip_smoke.py's phase 1 ("NVIDIA H100 80GB HBM3")
HBM_BYTES = 85_017_493_504
# the links: 8 ranks a node on NVLink 4 (900 GB/s a GPU both ways, 450 one
# way), and InfiniBand NDR between nodes (one 400 Gb/s ConnectX-7 a GPU)
NODE_RANKS = 8
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9


def peak_flops(dtype: str) -> float:
    """The card's peak rate for products in ``dtype`` (float32's for a
    type the table does not name)."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Each dtype's FLOPs at that dtype's peak, summed."""
    return sum(n / peak_flops(dt) for dt, n in flops_by_dtype.items())


def _bound(ops_ms: float, bytes_ms: float):
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


def bound(M: int, N: int, K: int, dtype: str, itemsize: int):
    """Least time the card could take for ``x (M, K) @ y (K, N)``, in ms,
    and what bounds it: the operations at the dtype's peak, or each input
    read and the output written once at HBM bandwidth."""
    ops_ms = operators.matmul_flops(M, N, K) / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = (M * K + K * N + M * N) * itemsize / HBM_BYTES_PER_S * 1e3
    return _bound(ops_ms, bytes_ms)


def scan_bound(Bsz: int, S: int, D: int, N: int, itemsize: int,
               with_h0: bool):
    """Least time the card could take for one scan, in ms: x, dt, B, C (and
    h0) read once, y and h_final written once, A read once, at HBM
    bandwidth; or ``operators.scan_flops`` at the CUDA cores' float32 peak,
    whatever the input type."""
    nbytes = (itemsize * (3 * Bsz * S * D + 2 * Bsz * S * N) + 4 * D * N
              + 4 * Bsz * D * N * (2 if with_h0 else 1))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = operators.scan_flops(Bsz, S, D, N) / PEAK_FLOPS["float32"] * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms,
                                                            "bytes")


def scan_grad_bound(Bsz: int, S: int, D: int, N: int, with_states: bool,
                    given_states: bool = False):
    """Least time the card could take for one scan backward in float32, in
    ms: x, dt, dy, B, C, A (and h0, dh_final; with ``given_states`` the
    forward's states, one every 16 steps) read once and dx, ddt, dB, dC,
    dA, dh0 written once at HBM bandwidth; or
    ``operators.scan_backward_flops`` at the CUDA cores' float32 peak."""
    nbytes = 4 * (5 * Bsz * S * D + 4 * Bsz * S * N + 2 * D * N
                  + (3 if with_states else 1) * Bsz * D * N
                  + (Bsz * -(-S // 16) * D * N if given_states else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (operators.scan_backward_flops(Bsz, S, D, N)
              / PEAK_FLOPS["float32"] * 1e3)
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms,
                                                            "bytes")


def flash_bound(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                causal: bool, dtype: str, itemsize: int,
                backward: bool = False):
    """Least time the card could take for one attention, in ms:
    ``operators.flash_flops`` (4 D operations per visible pair under the
    top-left causal mask) at the input type's peak, or q, k, v read once
    and the output written once at HBM bandwidth.  With ``backward``,
    forward and backward: 10 D more operations a pair (S recomputed, dV,
    dP, dQ, dK), and q, k, v, dO read and out, dq, dk, dv written."""
    flops = operators.flash_flops(B, H, Sq, Sk, D, causal)
    ops_ms = (3.5 if backward else 1.0) * flops / PEAK_FLOPS[dtype] * 1e3
    nbytes = itemsize * (4 if backward else 2) * (B * H * Sq * D
                                                  + B * KH * Sk * D)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return _bound(ops_ms, bytes_ms)


def flash_backward_bound(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                         causal: bool, dtype: str, itemsize: int):
    """Least time the card could take for the backward alone, in ms: the
    five products of the gradient, 10 D operations a visible pair
    (``operators.flash_flops`` × 2.5; the kernels do 14 D,
    ``operators.flash_backward_flops``), at the input type's peak; or q, k,
    v, out, dout and the float32 lse read once and dq, dk, dv written once
    at HBM bandwidth.  It exceeds ``flash_bound(..., backward=True)`` by at
    most the lse's bytes: forward and backward need no lse in memory."""
    flops = 2.5 * operators.flash_flops(B, H, Sq, Sk, D, causal)
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    # q, out, dout read and dq written; k, v read and dk, dv written
    nbytes = (itemsize * (4 * B * H * Sq * D + 4 * B * KH * Sk * D)
              + 4 * B * H * Sq)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return _bound(ops_ms, bytes_ms)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")
# operations that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_", "exponential_"}
# the files whose frames :func:`_where` skips to find the issuing code
_PLUMBING = ("/kernels/", "/launch/costs.py", "/parallel/sharding.py",
             "/torch/", "/contextlib.py")


# > 0 while DTensor derives an operation's global output shape by running
# it on global fake tensors (its sharding propagation): no rank runs that
_PAUSED = [0]


def _pause_in_sharding_propagation() -> None:
    """Have DTensor's sharding propagation, which runs each new operation
    once on fake tensors of the global shapes to learn its output's, run
    uncounted (once per process)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    inner = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(inner, "uncounted", False):
        return

    def uncounted(self, op_schema):
        _PAUSED[0] += 1
        try:
            return inner(self, op_schema)
        finally:
            _PAUSED[0] -= 1
    uncounted.uncounted = True
    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _desc(t: Any) -> str:
    if not isinstance(t, torch.Tensor):
        return repr(t)
    dt = str(t.dtype).removeprefix("torch.")
    text = f"{dt}[{','.join(map(str, t.shape))}]"
    placements = getattr(t, "placements", None)
    if placements is not None:
        text += "{" + ",".join(map(str, placements)) + "}"
    return text


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of a collective's group: from its group name (the
    functional collectives' last string argument) or its process group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(pytree.tree_leaves(args)):
        if isinstance(a, str):
            try:
                pg = _resolve_process_group(a)
            except (ValueError, RuntimeError):
                continue
            return tuple(dist.get_process_group_ranks(pg))
        if isinstance(a, dist.ProcessGroup):
            return tuple(dist.get_process_group_ranks(a))
    return ()


def _where() -> str:
    """The innermost frame outside the kernels, the counter, the sharding
    plumbing and torch: the model code that issued an operation."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if not any(p in path for p in _PLUMBING):
            name = path.rsplit("/src/", 1)[-1]
            return f"{name}:{f.f_lineno}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class Counter(TorchDispatchMode):
    """Count what each operation dispatched in the block costs this rank
    (module docstring).  ``log`` keeps the op log, ``where`` names the
    issuing code in it.  While it is active ``kernels/ops.py`` calls the
    kernels through their operators.

    After the block: :attr:`flops_by_dtype`, :attr:`flops_by_op`,
    :attr:`bytes`, :attr:`collectives` (one dict a collective: ``op``,
    ``bytes``, ``group``), :meth:`memory`, :meth:`text`, and
    :meth:`cost` (all of them as one dict)."""

    def __init__(self, *, log: bool = False, where: bool = False) -> None:
        super().__init__()
        self.log, self.where = log, where
        self.flops_by_dtype: Dict[str, int] = collections.Counter()
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.bytes = 0
        self.n_ops = 0
        self.collectives: List[Dict[str, Any]] = []
        self.lines: List[str] = []
        self._live = 0
        self._peak = 0
        self._args = 0
        self._outputs = 0
        self._tracked = weakref.WeakKeyDictionary()
        self._arg_storages = weakref.WeakSet()

    # -- memory --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Add ``t``'s storage to the live bytes unless it is tracked;
        returns the bytes added."""
        if t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        if st in self._tracked:
            return 0
        n = st.nbytes()
        self._tracked[st] = n
        self._live += n
        self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int) -> None:
        self._live -= n

    @staticmethod
    def _local(t: Any) -> Any:
        return t.to_local() if hasattr(t, "placements") else t

    def hold(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (DTensors' local ones)
        as live arguments of the run; returns their bytes."""
        n = 0
        for t in _tensors(tree):
            t = self._local(t)
            n += self._track(t)
            if t.device.type != "meta":
                self._arg_storages.add(t.untyped_storage())
        self._args += n
        return n

    def outputs(self, tree: Any) -> int:
        """Note ``tree`` (the run's result) as its outputs: the bytes of
        their storages that are not arguments (a storage updated in place
        is the argument's)."""
        seen, n = set(), 0
        for t in _tensors(tree):
            t = self._local(t)
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            if id(st) in seen or st in self._arg_storages:
                continue
            seen.add(id(st))
            n += st.nbytes()
        self._outputs = n
        return n

    def memory(self) -> Dict[str, int]:
        """The reference's memory record: the arguments held, the outputs
        noted, the peak of live bytes, and the rest of the peak as temp."""
        return {"argument_size_in_bytes": self._args,
                "output_size_in_bytes": self._outputs,
                "temp_size_in_bytes": max(self._peak - self._args
                                          - self._outputs, 0),
                "peak_memory_in_bytes": self._peak}

    # -- the mode ------------------------------------------------------
    def __enter__(self):
        if "torch.distributed.tensor" in sys.modules:
            _pause_in_sharding_propagation()
        operators.counting += 1
        return super().__enter__()

    def __exit__(self, *exc):
        operators.counting -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _PAUSED[0]:
            return func(*args, **kwargs)
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is not None and any(issubclass(t, dtensor.DTensor)
                                       for t in types):
            # a DTensor: let it dispatch; its local operations come back
            if self.log:
                self._line(f"dtensor {func}",
                           pytree.tree_leaves((args, kwargs)), [])
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in ins + outs):
            return out              # shapes only
        self.n_ops += 1
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in in_storages:
                self._track(t)
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVE_KINDS:
            nbytes = sum(_nbytes(t) for t in outs)
            event = {"op": _COLLECTIVE_KINDS[name], "bytes": nbytes,
                     "group": list(_group_ranks((args, kwargs)))}
            self.collectives.append(event)
            if self.log:
                self.lines.append(
                    f"collective {event['op']} bytes={nbytes} group="
                    + ",".join(map(str, event["group"])))
        flops, dtype = self._flops(func, packet, args, kwargs, out)
        if flops:
            self.flops_by_dtype[dtype] += flops
            self.flops_by_op[str(packet)] += flops
        moved = self._moved(func, name, ins, outs, in_storages)
        self.bytes += moved
        if self.log:
            self._line(str(func), ins, outs, flops, moved)
        return out

    def _flops(self, func, packet, args, kwargs, out) -> Tuple[int, str]:
        cost = operators.FLOPS.get(func)
        if cost is not None:
            return cost(args, out)
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(packet)
        if formula is None:
            return 0, ""
        outs = _tensors(out)
        dtype = outs[0].dtype if outs else _tensors(args)[0].dtype
        return (int(formula(*args, **kwargs, out_val=out)),
                str(dtype).removeprefix("torch."))

    @staticmethod
    def _moved(func, name: str, ins, outs, in_storages) -> int:
        """Bytes the operation moves: each tensor input read once, each
        output written once; nothing for a view or an allocation."""
        if not outs or name.startswith(("empty", "new_empty")):
            return 0
        if not func._schema.is_mutable and all(
                id(t.untyped_storage()) in in_storages for t in outs):
            return 0                  # a view: metadata only
        read = ins[1:] if name in _WRITE_ONLY else ins
        seen, n = set(), 0
        for t in read:
            if id(t) not in seen:
                seen.add(id(t))
                n += _nbytes(t)
        return n + sum(_nbytes(t) for t in outs)

    def _line(self, name: str, ins, outs, flops: int = 0,
              moved: int = 0) -> None:
        text = (f"{name} (" + ", ".join(_desc(t) for t in ins) + ")")
        if outs:
            text += " -> " + ", ".join(_desc(t) for t in outs)
        if flops:
            text += f" flops={flops}"
        if moved:
            text += f" bytes={moved}"
        if self.where:
            text += f" @ {_where()}"
        self.lines.append(text)

    # -- results -------------------------------------------------------
    def text(self) -> str:
        """The op log, one line an operation."""
        return "\n".join(self.lines) + ("\n" if self.lines else "")

    def cost(self) -> Dict[str, Any]:
        """FLOPs (total, by dtype, by operation), bytes, the collectives
        (their count, by kind, and the events) and the memory record."""
        return {"flops": sum(self.flops_by_dtype.values()),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "flops_by_op": dict(self.flops_by_op),
                "bytes accessed": self.bytes, "n_ops": self.n_ops,
                "collectives": len(self.collectives),
                "collectives_by_op": dict(collections.Counter(
                    e["op"] for e in self.collectives)),
                "collective_events": list(self.collectives),
                **self.memory()}

