"""The traced steps: ``torch.profiler`` over a few steady steps, with the
benchmark's own host spans, reduced to what the per-layer readers read.

The host spans are ``record_function`` ranges named ``portbench.<span>``
(``batch_copy``, ``step_enqueue``, ``loss_read``, and ``window`` around
all the traced steps), so they share the device events' clock.  The busy
time is the union of the device's operations (kernels, copies, sets)
inside the window; an idle gap is named by the span the host was in when
it began.
"""
from __future__ import annotations

import collections
import contextlib
from types import SimpleNamespace
from typing import Dict, List, Tuple

from .counts.kernels import PORT_KERNELS, matches, matches_one

PREFIX = "portbench."
SPANS = ("batch_copy", "step_enqueue", "loss_read")

Interval = Tuple[str, float, float]          # name, start µs, end µs


def span(torch, name: str):
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled(torch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """The device's operations and the benchmark's host spans."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for e in prof.events():
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith(PREFIX):
            if e.device_type == DeviceType.CPU:
                spans.append((e.name[len(PREFIX):],) + r[1:])
        elif e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            device.append(r)
    return device, spans


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda i: i[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def check_records(device: List[Interval], launched: Dict[str, int]) -> None:
    """Raise unless the trace holds, for each of the port's kernels, one
    record of each of its device kernels per launch its counter saw.  The
    profiler has been seen to drop records late in a long process, and a
    device kernel renamed away from its pattern would leave its reader
    nothing while its time went to the other operations: both refuse the
    run, a kernel with no record at all as much as one with too few."""
    for kernel, spec in PORT_KERNELS.items():
        want = launched.get(spec.counter, 0)
        for pattern in spec.records:
            got = sum(1 for name, _, _ in device
                      if matches_one(pattern, name))
            if got != want:
                raise RuntimeError(
                    f"the trace holds {got} records of {pattern!r} but "
                    f"{spec.counter} launched {want} times")


def reduce(prof, launched: Dict[str, int], steps: int) -> SimpleNamespace:
    """What the readers read: ``device`` (operations inside the window),
    ``spans``, ``window_us``, ``busy_us``, ``steps`` and the breakdown."""
    device, spans = events(prof)
    window = [s for s in spans if s[0] == "window"]
    if len(window) != 1:
        raise RuntimeError(f"expected one traced window, found {len(window)}")
    _, w0, w1 = window[0]
    device = [d for d in device if d[1] >= w0 and d[2] <= w1]
    check_records(device, launched)
    busy = merged(device)
    busy_us = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for name, s, e in device:
        by_name[name] += e - s
    gaps, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            gaps.append((_host_span(spans, t), (s - t) / 1e6))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[1])
    return SimpleNamespace(
        device=device, spans=spans, window_us=w1 - w0, busy_us=busy_us,
        steps=steps, breakdown={
            "device_ops": [[n[:160], us / 1e6]
                           for n, us in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]})


def _host_span(spans: List[Interval], t: float) -> str:
    inner = [s for s in spans if s[0] in SPANS and s[1] <= t < s[2]]
    return min(inner, key=lambda s: s[2] - s[1])[0] if inner else "other"


def device_seconds(rec, kernel: str) -> Tuple[int, float]:
    """Records of ``kernel``'s first device kernel (one a launch) and the
    device seconds of all its device kernels, in the traced steps."""
    spec = PORT_KERNELS[kernel]
    n = sum(1 for name, _, _ in rec.device
            if matches_one(spec.records[0], name))
    us = sum(e - s for name, s, e in rec.device if matches(kernel, name))
    return n, us / 1e6
