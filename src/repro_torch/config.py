"""One frozen configuration object for the cluster runtime.

Port of ``repro/config.py``, unchanged: the configuration is plain Python.

:class:`ClusterConfig` consolidates the ~30 keyword arguments that accreted
on :class:`repro_torch.cluster.ClusterExecutor` / :func:`repro_torch.core.make_executor`
/ :func:`repro_torch.core.run_graph` over the project's history (transport,
channel, fusion, collectives, checkpointing, fault policy, ...) into a
single validated, hashable value:

* **per-field validation** — every constraint the executor used to check at
  construction time (membership sets, positivity, cross-field requirements
  like ``resume`` needing ``checkpoint_dir``) is enforced in
  ``__post_init__`` with the field's own name in the error;
* **flags** — :meth:`ClusterConfig.add_flags` generates an argparse group
  from field metadata (single source of truth for flag names, help text,
  choices and backend gating used by ``launch/train.py`` / ``serve.py`` /
  ``driver.py``), :meth:`from_flags` rebuilds a config from a parsed
  namespace, and :meth:`to_flags` serializes the non-default fields back
  into CLI tokens (``from_flags(parse(to_flags()))`` round-trips);
* **back-compat shim** — :func:`resolve_config` maps the legacy keyword
  arguments onto config fields, emitting a :class:`DeprecationWarning`
  once per keyword name.  Old call sites keep working for one release:
  ``ClusterExecutor(4, fuse="auto")`` ≡
  ``ClusterExecutor(config=ClusterConfig(n_workers=4, fuse="auto"))``.

The gateway (``repro/gateway``) exposes :data:`TENANT_FIELDS` — the subset
of knobs a tenant may set per submitted job; everything else is fixed by
the operator when the shared pool starts.
"""
from __future__ import annotations

import argparse
import dataclasses
import warnings
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["ClusterConfig", "resolve_config", "TENANT_FIELDS"]

_START_METHODS = ("fork", "spawn", "forkserver")
_TRANSPORTS = ("auto", "shm", "sock", "tcp", "driver")
_CHANNELS = ("pipe", "spawn", "tcp")
_WORKER_SPECS = ("local", "remote")


def _flag(help: str, *, choices: Optional[Tuple[str, ...]] = None,
          parse: Any = None, backend: Optional[str] = None,
          metavar: Optional[str] = None) -> Dict[str, Any]:
    """Field metadata for a CLI-exposed knob.

    ``backend="process"`` marks a flag the thread backend cannot honour —
    ``validate_flags`` rejects a non-default value with the flag's own
    vocabulary (see ``launch/backend.py``).
    """
    return {"help": help, "choices": choices, "parse": parse,
            "backend": backend, "metavar": metavar}


def _opt_str(s: str) -> Optional[str]:
    return None if s in ("", "none", "auto") else s


def _opt_float(s: str) -> Optional[float]:
    return None if s in ("", "none") else float(s)


def _opt_int(s: str) -> Optional[int]:
    return None if s in ("", "none", "auto") else int(s)


@dataclass(frozen=True)
class ClusterConfig:
    """Every runtime knob of the cluster backend, as one frozen value.

    Fields mirror the historical ``ClusterExecutor`` keyword arguments
    one-to-one (same names, same defaults), so the legacy-kwarg shim is a
    pure rename-free mapping.  ``None`` means "backend default" for the
    optional fields (``shm_threshold`` falls back to the serde default,
    ``channel`` is inferred from ``start_method``/``connect``/pool shape,
    ``start_method`` is ``"fork"`` unless this process has initialised
    CUDA, then ``"spawn"``: a forked child cannot use CUDA once its parent
    has).  That last default is the port's own; the reference's is
    ``"fork"``.
    """

    # ---- pool shape / scheduling -----------------------------------
    n_workers: int = field(default=2, metadata=_flag(
        "worker-process pool size (a 'workers' spec list overrides it)"))
    policy: str = field(default="critical_path", metadata=_flag(
        "list-scheduling priority policy for the driver's placement plan"))
    worker_speed: Optional[Tuple[float, ...]] = None
    pipeline_depth: int = field(default=2, metadata=_flag(
        "super-tasks kept in flight per worker (driver-side pipelining)"))
    outputs_only: bool = field(default=False, metadata=_flag(
        "return only marked outputs and GC intermediates eagerly "
        "(memory-bounded production mode)"))
    progress_timeout: float = field(default=60.0, metadata=_flag(
        "seconds without any cluster completion before the run aborts"))
    start_method: Optional[str] = field(default=None, metadata=_flag(
        "multiprocessing start method for local workers (auto: fork, or "
        "spawn once this process has initialised CUDA)",
        choices=("auto",) + _START_METHODS, parse=_opt_str))
    seed: int = field(default=0, metadata=_flag(
        "tie-break seed for the scheduler"))
    # ---- data plane -------------------------------------------------
    transport: str = field(default="auto", metadata=_flag(
        "process-backend data plane: zero-copy shared memory, direct "
        "unix-socket or TCP pulls, or the driver-relayed pipe path "
        "(A/B baseline)", choices=_TRANSPORTS, backend="process"))
    shm_threshold: Optional[int] = None
    bandwidth: float = float(256 << 20)
    # ---- control plane ----------------------------------------------
    channel: Optional[str] = field(default=None, metadata=_flag(
        "process-backend control plane: in-host pipes (forked/spawned "
        "workers) or the multi-host TCP listener (workers dial in; see "
        "repro-worker)", choices=("auto",) + _CHANNELS, parse=_opt_str,
        backend="process"))
    connect: Optional[str] = field(default=None, metadata=_flag(
        "host:port the driver binds for dialing workers (TCP channel); "
        "port 0 picks an ephemeral port", parse=_opt_str,
        metavar="HOST:PORT", backend="process"))
    workers: Optional[Tuple[str, ...]] = None
    token: Optional[str] = field(default=None, metadata=_flag(
        "shared secret for the TCP handshake (workers and clients must "
        "present it)", parse=_opt_str, backend="process"))
    accept_timeout: float = 60.0
    heartbeat_interval: float = field(default=1.0, metadata=_flag(
        "seconds between driver->worker liveness probes (TCP channel)",
        backend="process"))
    heartbeat_timeout: float = field(default=15.0, metadata=_flag(
        "seconds of heartbeat silence before a worker is suspected dead",
        backend="process"))
    heartbeat_jitter: float = 0.25
    # ---- graph compilation / execution policy -----------------------
    speculate_after: Optional[float] = field(default=None, metadata=_flag(
        "speculatively re-execute a task running longer than X times its "
        "expected duration on an idle worker (first completion wins; off "
        "by default — see docs/speculation.md)", parse=_opt_float,
        metavar="X", backend="process"))
    fuse: Any = field(default="off", metadata=_flag(
        "compile the task graph into super-tasks before dispatch (fuse "
        "chains, small fan-ins, sibling groups) so fine-grained graphs "
        "stop paying one driver round-trip per node; N caps members per "
        "super-task (see docs/fusion.md)", metavar="{auto,off,N}",
        backend="process"))
    collectives: Any = field(default="auto", metadata=_flag(
        "lower broadcast/scatter/gather/all_reduce nodes into staged tree "
        "hops over the peer data plane instead of N×M point-to-point "
        "edges; off executes each collective's dense fallback on one "
        "worker, N overrides the tree arity (see docs/collectives.md)",
        metavar="{auto,off,N}", backend="process"))
    adaptive: str = field(default="off", metadata=_flag(
        "profile-guided adaptive replanning: auto feeds measured task "
        "durations back into the planner mid-run (calibrated scheduling "
        "costs, re-fusion of lopsided not-yet-dispatched clusters, "
        "derived keep-parallelism and speculate-after); off pins every "
        "planning decision to plan time (see docs/adaptive.md)",
        choices=("off", "auto"), backend="process"))
    keep_parallelism: Optional[int] = field(default=None, metadata=_flag(
        "sibling-packing parallelism floor for fusion and re-fusion; "
        "default derives it from the live worker count under "
        "--adaptive auto and uses the static fusion default otherwise",
        parse=_opt_int, metavar="N", backend="process"))
    refuse_skew: float = field(default=4.0, metadata=_flag(
        "duration-skew hysteresis threshold (max/median of observed "
        "seconds-per-cost-unit) above which the adaptive runtime "
        "re-fuses the not-yet-dispatched frontier", metavar="X",
        backend="process"))
    # ---- checkpointing / resume -------------------------------------
    checkpoint_dir: Optional[str] = field(default=None, metadata=_flag(
        "directory for the driver's append-only run log (enables "
        "--resume after a driver crash)", parse=_opt_str,
        backend="process"))
    checkpoint_interval: float = field(default=0.25, metadata=_flag(
        "seconds between run-log fsync batches", backend="process"))
    resume: Optional[str] = field(default=None, metadata=_flag(
        "run id (or 'latest') to resume from checkpoint_dir",
        parse=_opt_str, metavar="RUN_ID", backend="process"))
    rejoin_timeout: float = 10.0
    rejoin_window: Optional[float] = None
    # ---- failure policy / chaos hooks -------------------------------
    fail_worker: Optional[Tuple[int, int]] = None
    join_after: Optional[Tuple[int, int]] = None
    fail_driver: Optional[int] = None
    fault_plan: Optional[Any] = None
    suspect_grace: float = field(default=5.0, metadata=_flag(
        "seconds a heartbeat-silence death verdict is held as suspicion "
        "before lineage recovery runs", backend="process"))
    quarantine_after: int = 3
    probe_interval: float = 2.0
    fetch_retry: Optional[Any] = None

    # ------------------------------------------------------------ checks
    def __post_init__(self) -> None:
        def norm(name: str, value: Any) -> None:
            object.__setattr__(self, name, value)

        if self.worker_speed is not None:
            norm("worker_speed", tuple(float(s) for s in self.worker_speed))
        if self.workers is not None:
            norm("workers", tuple(self.workers))
            bad = [w for w in self.workers if w not in _WORKER_SPECS]
            if bad:
                raise ValueError(
                    f"workers: unknown worker spec(s) {bad!r} "
                    f"(expected one of {_WORKER_SPECS})")
            norm("n_workers", len(self.workers))
        if self.fail_worker is not None:
            norm("fail_worker", tuple(self.fail_worker))
        if self.join_after is not None:
            norm("join_after", tuple(self.join_after))
        if self.n_workers < 1:
            raise ValueError("n_workers >= 1")
        if (self.start_method is not None
                and self.start_method not in _START_METHODS):
            raise ValueError(
                f"unknown start_method {self.start_method!r}")
        if self.transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(expected one of {_TRANSPORTS})")
        if self.channel is not None and self.channel not in _CHANNELS:
            raise ValueError(f"unknown channel {self.channel!r} "
                             f"(expected one of {_CHANNELS})")
        if self.shm_threshold is not None and self.shm_threshold < 1:
            raise ValueError("shm_threshold must be >= 1 byte")
        if self.bandwidth <= 0:
            raise ValueError("bandwidth must be positive bytes/second")
        if self.speculate_after is not None and self.speculate_after <= 0:
            raise ValueError("speculate_after must be a positive "
                             "×expected-duration multiple (or None to "
                             "disable speculation)")
        if self.fail_driver is not None and self.fail_driver < 1:
            raise ValueError("fail_driver must be a positive completion "
                             "count (or None to disable crash emulation)")
        if self.adaptive not in ("off", "auto"):
            raise ValueError(f"unknown adaptive mode {self.adaptive!r} "
                             "(expected 'off' or 'auto')")
        if self.keep_parallelism is not None and self.keep_parallelism < 1:
            raise ValueError("keep_parallelism must be >= 1 sibling "
                             "groups (or None to derive it)")
        if self.refuse_skew <= 1.0:
            raise ValueError("refuse_skew must be > 1 (a max/median "
                             "duration-skew ratio)")
        if self.resume is not None and self.checkpoint_dir is None:
            raise ValueError("resume requires checkpoint_dir")
        if self.checkpoint_interval < 0:
            raise ValueError("checkpoint_interval must be >= 0 seconds")
        for name in ("progress_timeout", "accept_timeout",
                     "heartbeat_interval", "heartbeat_timeout"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive seconds")
        # fuse/collectives specs: validate at the field, not deep in the
        # executor (lazy import: config must stay importable without torch)
        from repro_torch.core.fusion import parse_fuse_spec
        from repro_torch.core.collectives import parse_collectives_spec
        norm("fuse", parse_fuse_spec(self.fuse))
        norm("collectives", parse_collectives_spec(self.collectives))

    # ------------------------------------------------------------- flags
    @classmethod
    def flag_fields(cls) -> List[Any]:
        """Dataclass fields that carry CLI metadata, in declaration order."""
        return [f for f in fields(cls) if "help" in f.metadata]

    @classmethod
    def add_flags(cls, ap: argparse.ArgumentParser,
                  names: Optional[Sequence[str]] = None,
                  title: str = "cluster runtime",
                  defaults: Optional[Dict[str, Any]] = None) -> None:
        """Add one argparse group generated from field metadata.

        ``names`` restricts the group to a subset of flaggable fields (the
        launchers expose only the knobs their workloads exercise); flag
        destinations are the field names, so :meth:`from_flags` can read
        any namespace this produced.  ``defaults`` overrides per-flag
        defaults without forking the help text (the launchers default
        ``--fuse`` to ``auto`` while the library default stays ``off``).
        """
        grp = ap.add_argument_group(title)
        want = set(names) if names is not None else None
        for f in cls.flag_fields():
            if want is not None and f.name not in want:
                continue
            meta = f.metadata
            flag = "--" + f.name.replace("_", "-")
            default = f.default
            if defaults is not None and f.name in defaults:
                default = defaults[f.name]
            if f.type in ("bool", bool) or isinstance(default, bool):
                grp.add_argument(flag, action="store_true",
                                 default=default, help=meta["help"])
                continue
            parse = meta["parse"]
            if parse is None:
                parse = type(default) if default is not None else str
            kw: Dict[str, Any] = {"default": default, "type": parse,
                                  "help": meta["help"]}
            if meta["choices"]:
                kw["choices"] = list(meta["choices"])
                # an optional-str field parses "auto" to None, which must
                # stay an admissible choice post-parse
                if parse is _opt_str:
                    kw["choices"] = [None] + [c for c in kw["choices"]
                                              if c != "auto"]
                    kw["metavar"] = "{%s}" % ",".join(meta["choices"])
            if meta["metavar"]:
                kw["metavar"] = meta["metavar"]
            grp.add_argument(flag, **kw)

    @classmethod
    def from_flags(cls, args: argparse.Namespace,
                   names: Optional[Sequence[str]] = None,
                   **overrides: Any) -> "ClusterConfig":
        """Build a config from a parsed namespace (only the fields whose
        destinations are present), plus explicit ``overrides``.

        A launcher that exposed a subset via ``add_flags(names=...)``
        must read back the SAME subset: its own unrelated flags may
        share a destination with a config field (``train.py --resume``
        is a model-checkpoint toggle, ``--seed`` a data-order seed) and
        would otherwise leak into the cluster config."""
        kw: Dict[str, Any] = {}
        want = set(names) if names is not None else None
        for f in cls.flag_fields():
            if want is not None and f.name not in want:
                continue
            if hasattr(args, f.name):
                kw[f.name] = getattr(args, f.name)
        kw.update(overrides)
        return cls(**kw)

    def to_flags(self) -> List[str]:
        """Serialize the non-default flaggable fields back to CLI tokens.

        ``from_flags(parser.parse_args(cfg.to_flags()))`` reproduces
        ``cfg`` for every field that has a flag; non-flag fields (fault
        plans, retry policies, injection hooks) are process-local values
        with no CLI form and are intentionally dropped.
        """
        out: List[str] = []
        for f in self.flag_fields():
            value = getattr(self, f.name)
            if value == f.default:
                continue
            flag = "--" + f.name.replace("_", "-")
            if isinstance(value, bool):
                if value:
                    out.append(flag)
            elif value is None:
                out.extend([flag, "none"])
            else:
                out.extend([flag, str(value)])
        return out

    # ------------------------------------------------------------ helpers
    def replace(self, **changes: Any) -> "ClusterConfig":
        return dataclasses.replace(self, **changes)

    def executor_kwargs(self) -> Dict[str, Any]:
        """The config as the executor's legacy keyword dict (shim-free
        internal path; also what the gateway journals per session)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}


#: knobs a gateway tenant may set per submitted job; everything else
#: (pool shape, transports, fusion/collectives specs, checkpointing,
#: fault policy) belongs to the operator who started the shared pool —
#: jobs share one resident plan universe, so even the fuse spec is
#: pool-level.  A submit carrying any other key is rejected before the
#: graph is unpickled (repro/gateway/service.py).  See docs/gateway.md.
TENANT_FIELDS = frozenset({"outputs_only", "label"})


_FIELD_NAMES = tuple(f.name for f in fields(ClusterConfig))
_warned_kwargs: set = set()


def _warn_legacy(name: str, owner: str) -> None:
    if name in _warned_kwargs:
        return
    _warned_kwargs.add(name)
    warnings.warn(
        f"passing {name!r} as a keyword to {owner} is deprecated; pass "
        f"config=repro_torch.ClusterConfig({name}=...) instead (legacy keywords "
        f"keep working for one release)",
        DeprecationWarning, stacklevel=4)


def resolve_config(config: Optional[ClusterConfig],
                   legacy: Dict[str, Any], *,
                   owner: str = "ClusterExecutor") -> ClusterConfig:
    """Merge legacy keyword arguments into ``config`` (shim).

    Every historical keyword maps one-to-one onto a :class:`ClusterConfig`
    field; unknown names raise ``TypeError`` exactly like a misspelled
    keyword always did.  Legacy keywords override ``config`` fields and
    warn once per name per process.
    """
    unknown = sorted(set(legacy) - set(_FIELD_NAMES))
    if unknown:
        raise TypeError(
            f"{owner}() got unexpected keyword argument(s) {unknown}; "
            f"valid ClusterConfig fields: {sorted(_FIELD_NAMES)}")
    if config is None:
        config = ClusterConfig() if legacy else _DEFAULT_CONFIG
    if legacy:
        for name in legacy:
            _warn_legacy(name, owner)
        config = dataclasses.replace(config, **legacy)
    return config


_DEFAULT_CONFIG = ClusterConfig()
