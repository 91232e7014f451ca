"""The port's tracing: torch.profiler traces, and the spans, counters and
intervals the program records while one runs (port of
sparc_ldpc_tpu/utils/profiling.py's `trace` and `annotate`).

- `trace(logdir)`: torch.profiler over CPU and CUDA activity around a
  block; writes logdir/trace.json (Chrome trace format, readable by
  Perfetto) and logdir/counters.json (the readers' view of the registry
  below); the CLI's --profile.
- `tracing()`: True while a torch.profiler records in this process: the
  autograd profiler's own flag, read once; no switch of its own.
- `annotate(name)`: a span, a `record_function` range in that trace, on
  the clock of its kernel, copy and memset events; without a profiler one
  shared no-op context, with no call into the dispatcher.
- `count(name, value)`: while tracing, adds a host number, or the sum of
  a tensor's elements, to a named counter.  The tensor is kept as it is
  and summed when read, so the hot path neither waits for the device nor
  launches a reduction.
- `interval(name, device)`: a context that, while tracing, records a
  pair of timing events on `device`'s current stream (the host clock on
  the CPU) into a named list.
- `group(name, **fields)`: a named dict of counters that count in every
  run, traced or not (the section exchange's, parallel/mesh.py).

Readers: `counters()`, `intervals_ms(name)`, `groups()`; `reset()`.

Names are `<layer>.<what>`.  Counters and intervals record only while a
profiler runs, so a traced window counts its own work and nothing of an
untraced warm-up; a second traced window in one process starts with
`reset()` (as `trace` does).  An untraced run pays one flag read a site.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

_PROF = torch.autograd.profiler
_NOOP = contextlib.nullcontext()


def tracing() -> bool:
    """True while a torch.profiler records in this process."""
    return _PROF._is_profiler_enabled


class _Registry:
    """counts: name -> [host sum, tensors to sum when read]; intervals:
    name -> [(start mark, end mark, device)]; groups: name -> dict."""

    def __init__(self):
        self.counts: Dict[str, list] = {}
        self.intervals: Dict[str, List[tuple]] = {}
        self.groups: Dict[str, dict] = {}


_REG = _Registry()


def annotate(name: str):
    """A span named `name` while tracing, else the shared no-op."""
    if not tracing():
        return _NOOP
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """While tracing, add value (a host number, or a tensor whose elements
    are summed when read) to the counter `name`."""
    if not tracing():
        return
    entry = _REG.counts.setdefault(name, [0, []])
    if isinstance(value, torch.Tensor):
        entry[1].append(value.detach())
    else:
        entry[0] += value


def _mark(device: torch.device):
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Interval:
    __slots__ = ("name", "device", "start")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        self.start = _mark(self.device)
        return self

    def __exit__(self, *exc) -> bool:
        _REG.intervals.setdefault(self.name, []).append(
            (self.start, _mark(self.device), self.device))
        return False


def interval(name: str, device):
    """While tracing, a context whose entry and exit are marked on device's
    current stream (CUDA events) or the host clock; else the no-op."""
    if not tracing():
        return _NOOP
    return _Interval(name, torch.device(device))


def group(name: str, **fields) -> dict:
    """The registry's dict `name` (made from fields on first use), whose
    counters its owner updates in every run."""
    return _REG.groups.setdefault(name, dict(fields))


def counters() -> Dict[str, float]:
    """Every counter as a float: its host part plus its tensors' elements,
    summed on their devices (reading waits for them)."""
    out = {}
    for name, (host, tensors) in _REG.counts.items():
        total = float(host)
        by_dev: Dict[torch.device, list] = {}
        for t in tensors:
            by_dev.setdefault(t.device, []).append(
                t.reshape(-1).to(torch.float64))
        for ts in by_dev.values():
            total += torch.cat(ts).sum().item()
        out[name] = total
    return out


def intervals_ms(name: str) -> List[Tuple[float, Optional[int]]]:
    """Each interval `name` recorded: (milliseconds on its device's clock,
    or the host's on the CPU; the device index, None on the CPU)."""
    out = []
    for a, b, dev in _REG.intervals.get(name, []):
        if isinstance(a, float):
            ms = (b - a) * 1e3
        else:
            b.synchronize()
            ms = a.elapsed_time(b)
        out.append((ms, dev.index))
    return out


def groups() -> Dict[str, dict]:
    return {k: dict(v) for k, v in _REG.groups.items()}


def reset() -> None:
    """Counters and intervals emptied, every group's fields set to 0."""
    _REG.counts.clear()
    _REG.intervals.clear()
    for g in _REG.groups.values():
        for k, v in g.items():
            g[k] = type(v)()


def summary() -> Dict[str, dict]:
    """What counters.json holds: the counters, each interval list's count
    and mean milliseconds, and the groups."""
    ivs = {}
    for name in _REG.intervals:
        ms = [m for m, _ in intervals_ms(name)]
        ivs[name] = dict(count=len(ms), mean_ms=sum(ms) / len(ms))
    return dict(counters=counters(), intervals=ivs, groups=groups())


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block, the registry reset at its start;
    writes logdir/trace.json and logdir/counters.json (`summary`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(summary(), f, indent=1, sort_keys=True)
