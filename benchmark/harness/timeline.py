"""The profiler's timeline of a traced window, reduced to intervals.

torch.profiler's Chrome trace holds complete events ("ph": "X") with a
start `ts` and a duration `dur` in microseconds on one clock for host and
device.  Device work is the events of the categories in DEVICE_CATS, each
on the card in its "device" argument; host activity is the operator and
annotation events.  The benchmark marks its window with an annotation
(WINDOW) and reads everything inside it.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "benchmark.window"

Interval = Tuple[float, float]


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters; other names up to their first
    parenthesis."""
    s = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)",
                                             "anonymous"))
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    s = "".join(out).strip()
    return s.split("::")[-1] or name


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def covered(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the intervals cover."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class Timeline:
    def __init__(self, events: Sequence[Dict]):
        self.device: List[Dict] = []
        self.host: List[Dict] = []
        self.window: Optional[Interval] = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"])
            ev = dict(name=e.get("name", ""), cat=cat, t0=t0,
                      t1=t0 + float(e["dur"]))
            if cat in DEVICE_CATS:
                args = e.get("args", {})
                ev["dev"] = int(args.get("device", e.get("pid", 0)))
                self.device.append(ev)
            elif cat in HOST_CATS:
                ev["tid"] = e.get("tid")
                self.host.append(ev)
                if ev["name"] == WINDOW:
                    self.window = (ev["t0"], ev["t1"])

    @staticmethod
    def load(path: str) -> "Timeline":
        with open(path) as f:
            data = json.load(f)
        return Timeline(data["traceEvents"] if isinstance(data, dict)
                        else data)

    def span(self) -> Interval:
        if self.window is None:
            raise ValueError(f"the trace has no {WINDOW} annotation")
        return self.window

    def seconds(self) -> float:
        a, b = self.span()
        return (b - a) * 1e-6

    def intervals(self, dev: Optional[int] = None, cats=DEVICE_CATS,
                  names: Optional[Sequence[str]] = None,
                  exclude: Optional[Sequence[str]] = None) -> List[Interval]:
        """Device intervals in the window: of card dev (None: all), of the
        categories cats, whose short names are in names (None: any) and
        not in exclude."""
        lo, hi = self.span()
        out = []
        for e in self.device:
            if dev is not None and e["dev"] != dev:
                continue
            if e["cat"] not in cats:
                continue
            nm = short_name(e["name"])
            if names is not None and nm not in names:
                continue
            if exclude is not None and nm in exclude:
                continue
            out.extend(clip([(e["t0"], e["t1"])], lo, hi))
        return out

    def device_seconds(self, **kw) -> float:
        """Summed device time (not their union) of the selected events."""
        return sum(b - a for a, b in self.intervals(**kw)) * 1e-6

    def busy_seconds(self, dev: int) -> float:
        lo, hi = self.span()
        return covered(self.intervals(dev), lo, hi) * 1e-6

    def idle_share(self, dev: int) -> float:
        a, b = self.span()
        return 1.0 - self.busy_seconds(dev) / ((b - a) * 1e-6)

    def host_at(self, times: Sequence[float]) -> List[str]:
        """The innermost host operation of the window's thread running at
        each of the times, or "python" where none is.  Events of one
        thread nest, so a sweep over the sorted times with a stack of the
        open events finds them: the innermost is the last opened."""
        tid = next((e["tid"] for e in self.host if e["name"] == WINDOW),
                   None)
        evs = sorted((e for e in self.host
                      if e["tid"] == tid and e["name"] != WINDOW),
                     key=lambda e: (e["t0"], -e["t1"]))
        order = sorted(range(len(times)), key=lambda i: times[i])
        out = ["python"] * len(times)
        stack: List[Dict] = []
        j = 0
        for i in order:
            t = times[i]
            while j < len(evs) and evs[j]["t0"] <= t:
                while stack and stack[-1]["t1"] < evs[j]["t0"]:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1]["t1"] < t:
                stack.pop()
            if stack:
                out[i] = stack[-1]["name"]
        return out

    def top_device_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        lo, hi = self.span()
        for e in self.device:
            for a, b in clip([(e["t0"], e["t1"])], lo, hi):
                nm = short_name(e["name"])
                tot[nm] = tot.get(nm, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                ][:k]

    def top_idle_gaps(self, dev: int, k: int = 10) -> List[List]:
        """Card dev's idle time in the window, summed by what the host was
        doing at the middle of each gap, the largest k."""
        lo, hi = self.span()
        tot: Dict[str, float] = {}
        idle = gaps(self.intervals(dev), lo, hi)
        names = self.host_at([0.5 * (a + b) for a, b in idle])
        for (a, b), nm in zip(idle, names):
            tot[nm] = tot.get(nm, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                ][:k]
