"""The measured window: the campaign's own dispatch, driven for a fixed time.

The window calls `run_point` (the campaign CLI's pipelined path) again and
again, each call a fresh point index for a fixed number of blocks (the
frame-error budget out of reach, so the trial cap ends it), until the time
is up; the call under way then runs to its end and counts.  Around the
program it records, from the benchmark's own side:

- a completion mark behind every block (a CUDA event on the home device's
  stream after `run_block` returns; the host clock on the CPU);
- `Calls`: the calls into the layers whose kernels have a roofline
  (benchmark/rooflines), with what their count needs;
- `Capture`: the per-frame outputs of the blocks whose results are
  checked, where the system produces them.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import torch

COUNTERS = ("bit_errors", "frame_errors", "section_errors", "trials",
            "iters_sum", "bp_ok", "bit_errors_sq")
# the warm-up's point index, which no window reaches
WARM_POINT = 2 ** 32 - 1


class Marks:
    """Completion marks on the device clock (CUDA events) or the host's."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Calls:
    """Wrappers around each roofline's CALLS (module, function) that
    record, while `on`, the module's `record(args, kwargs, result)`."""

    def __init__(self, roofs: Dict[str, object]):
        self.on = False
        self.recs: Dict[str, List[Dict]] = {k: [] for k in roofs}
        self.undo: List[Tuple[object, str, object]] = []
        for kernel, mod in roofs.items():
            for modname, attr in mod.CALLS:
                self._wrap(importlib.import_module(modname), attr, kernel,
                           mod)

    def _wrap(self, module, attr: str, kernel: str, roof) -> None:
        orig = getattr(module, attr)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            if self.on:
                rec = roof.record(args, kw, out)
                if rec is not None:
                    self.recs[kernel].append(rec)
            return out

        setattr(module, attr, wrapped)
        self.undo.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self.undo):
            setattr(module, attr, orig)
        self.undo.clear()


class Capture:
    """Per-frame outputs of the checked blocks.

    `sample` holds (call, block) positions drawn from the seed; the block
    at each position is kept.  A position the window did not reach is
    taken from the last call instead, which the rolling capture of each
    block index holds."""

    def __init__(self):
        self.sample: Set[Tuple[int, int]] = set()
        self.active = False
        self.cur: Dict[str, object] = {}
        self.kept: Dict[Tuple[int, int], Dict] = {}
        self.rolling: Dict[int, Tuple[Tuple[int, int], Dict]] = {}

    def begin(self, point: int, block: int) -> None:
        self.active = ((point, block) in self.sample
                       or block in {j for _, j in self.sample})
        self.cur = {}

    def put(self, name: str, value) -> None:
        if self.active:
            self.cur[name] = value

    def end(self, point: int, block: int) -> None:
        if not self.active:
            return
        if (point, block) in self.sample:
            self.kept[(point, block)] = self.cur
        self.rolling[block] = ((point, block), self.cur)
        self.active = False

    def chosen(self) -> List[Tuple[Tuple[int, int], Dict]]:
        return [((c, j), self.kept[(c, j)]) if (c, j) in self.kept
                else self.rolling[j] for c, j in sorted(self.sample)]


@dataclass
class Window:
    blocks: List[Dict] = field(default_factory=list)
    start: object = None
    t0: float = 0.0
    t1: float = 0.0
    points: int = 0
    error: Optional[str] = None


def synchronize(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def drive(system, traffic: Dict, seconds: float, seed: int, marks: Marks,
          capture: Capture, journal: Optional[str], devices,
          on_start=None, point0: int = 0, calls: int = 0,
          per_call: Optional[int] = None) -> Window:
    """Run campaign calls from point point0 on until `seconds` have passed
    (or `calls` calls, when given), each of per_call (traffic's
    blocks_per_call) blocks of traffic's batch."""
    from sparc_ldpc_tpu_torch.parallel.campaign import run_point
    from sparc_ldpc_tpu_torch.utils.io import CampaignState

    B = traffic["batch"]
    per_call = per_call or traffic["blocks_per_call"]
    policy = system.policy
    state = None
    if journal is not None:
        state = CampaignState(journal, 1 if policy is None
                              else policy.section_shards, system.home.type)
    w = Window()
    pos = {"point": point0, "block": 0}

    def run_block(gen, batch):
        capture.begin(pos["point"], pos["block"])
        out = system.run_block(gen, batch)
        capture.end(pos["point"], pos["block"])
        w.blocks.append(dict(point=pos["point"], block=pos["block"],
                             out=out, done=marks.mark()))
        pos["block"] += 1
        return out

    if on_start is not None:
        on_start()
    w.start = marks.mark()
    w.t0 = time.perf_counter()
    point = point0
    try:
        while True:
            pos.update(point=point, block=0)
            run_point(run_block, seed, B, min_frame_errors=1 << 62,
                      max_trials=per_call * B, state=state, point_idx=point,
                      device=system.home, policy=policy)
            point += 1
            done = point - point0
            if (calls and done >= calls) or (
                    not calls and time.perf_counter() - w.t0 >= seconds):
                break
    except Exception as e:              # a block that raised
        w.error = f"{type(e).__name__}: {e}"
    synchronize(devices)
    w.t1 = time.perf_counter()
    w.points = point - point0
    return w


def to_host(x):
    """Tensors (in dicts, lists) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def counters(w: Window, marks: Marks) -> Tuple[List[Dict], List[float]]:
    """Each block's counters, and the milliseconds between successive
    block completions (the first from the window's start)."""
    rows, done = [], []
    for b in w.blocks:
        rows.append(dict(point=b["point"], block=b["block"],
                         **{k: float(v) for k, v in b["out"].items()
                            if k in COUNTERS}))
        done.append(marks.ms(w.start, b["done"]))
    gaps, prev = [], 0.0
    for t in done:
        gaps.append(t - prev)
        prev = t
    return rows, gaps
