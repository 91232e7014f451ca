"""Timing and tracing helpers (port of sparc_ldpc_tpu/utils/profiling.py).

- `timeit_blocked`: steady-state wall clock of a callable, warm-up calls
  excluded, each timed region ending in `torch.cuda.synchronize()` when the
  output lives on the GPU (PyTorch returns before the device finishes).
- `trace`: `torch.profiler` over CPU and CUDA activity, written as a Chrome
  trace into a directory; the CLI's --profile flag.
- `annotate`: a named range in that trace (`record_function`), for cost
  attribution by stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Tuple

import torch


def _sync(out) -> None:
    """Wait for the device when `out` holds a CUDA tensor."""
    leaves = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def timeit_blocked(fn: Callable, *args, warmup: int = 1, reps: int = 5,
                   **kw) -> Tuple[float, object]:
    """Returns (seconds_per_call, last_output); warm-up excluded."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    _sync(out)
    return (time.perf_counter() - t0) / reps, out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block; writes logdir/trace.json (Chrome
    trace format, readable by Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def throughput_report(fn: Callable, args: tuple, bits_per_call: int,
                      reps: int = 5) -> Dict[str, float]:
    """bits/s and latency of a decode callable."""
    dt, _ = timeit_blocked(fn, *args, reps=reps)
    return dict(seconds_per_call=dt, bits_per_s=bits_per_call / dt)
