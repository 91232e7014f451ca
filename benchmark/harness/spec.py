"""What the benchmark runs, found by name in its files.

- BENCHMARK.json at the checkout's root: the cells, the metrics and which
  cells each metric is read in;
- benchmark/configs/<config>.json: a code configuration, whose "system"
  names the module benchmark/systems/<system>.py that builds it;
- benchmark/traffic/<traffic>.json: the stream of trial blocks (batch,
  Eb/N0, blocks a campaign call);
- benchmark/workloads/<cell>.json: how a cell's outputs are checked (the
  blocks compared and each number's limit);
- benchmark/metrics/<metric>.py: one reader a metric, `read(run)`;
- benchmark/rooflines/<kernel>.py: a kernel's names in the trace, the calls
  that launch it and the least time of their work.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List

# the benchmark's package (its modules) and its data files
PKG_DIR = Path(__file__).resolve().parent.parent
BENCH_DIR = PKG_DIR
ROOT = PKG_DIR.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Dict) -> Dict:
    """The cell `name`: its entry in BENCHMARK.json with its configuration,
    traffic and check files read."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = dict(entries[0])
    w["config_file"] = _json(BENCH_DIR / "configs" / f"{w['config']}.json")
    w["traffic_file"] = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    w["check_file"] = _json(BENCH_DIR / "workloads" / f"{name}.json")
    return w


def metrics_for(cell_name: str, bench: Dict, traced: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    return importlib.import_module(f"benchmark.metrics.{metric}")


def system(name: str):
    return importlib.import_module(f"benchmark.systems.{name}")


def rooflines() -> Dict[str, object]:
    """Every kernel's roofline module, by kernel name."""
    return {p.stem: importlib.import_module(f"benchmark.rooflines.{p.stem}")
            for p in sorted((PKG_DIR / "rooflines").glob("*.py"))
            if not p.stem.startswith("_")}
