"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 ...
        [--control-seeds 3]

Builds the cell's program once and warms it up as a run does; then, for
each seed, drives one campaign call of the cell's traffic (point 0 of that
base seed) and checks its blocks as a run checks them:

- `program`: the program's per-frame outputs against the reference, by
  run.py's own `judge` (the lower readings);
- `control` (the first --control-seeds seeds): the reference itself put in
  the program's place with its transforms' operands in float8 e4m3, the
  precision below the configuration's bfloat16, against the reference (the
  upper readings).

Every comparison number is printed, compared or not, one JSON line a seed
on standard output.  It needs the cell's cards, as a run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec, window  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.run import (  # noqa: E402
    SEED_SPACE, cards, draw_sample, judge, prepare, stack)


def main(argv=None, devices=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    cell = spec.cell(args.workload, spec.benchmark())
    if devices is None:
        devices = cards(cell)
        if devices is None:
            return 2
    devices = [torch.device(d) for d in devices]
    home = devices[0]
    cfg, traffic, checks = (cell["config_file"], cell["traffic_file"],
                            cell["check_file"])
    sysmod, system, capture, marks, _ = prepare(cfg, traffic, devices, 0)
    ref = sysmod.System.reference(cfg, traffic["ebno_db"], home, "bf16")
    control = ref.with_rounding("fp8")
    per_call = traffic["blocks_per_call"]
    for i, s in enumerate(args.seeds):
        seed = s % SEED_SPACE
        capture.sample = draw_sample(seed, checks["check_blocks"], 1,
                                     per_call)
        t = time.perf_counter()
        w = window.drive(system, traffic, 0, seed, marks, capture, None,
                         devices, calls=1)
        if w.error:
            raise RuntimeError(w.error)
        rows, _ = window.counters(w, marks)
        at = {(r["point"], r["block"]): r for r in rows}
        chosen = [(pos, window.to_host(c)) for pos, c in capture.chosen()]
        win_s = time.perf_counter() - t
        rec = dict(cell=args.workload, seed=s, blocks=[list(p) for p, _ in
                                                       chosen])
        t = time.perf_counter()
        rec["program"], rec["malformed"], rcat = judge(
            ref, sysmod, traffic, seed, chosen, at, devices)
        if i < args.control_seeds:
            o = [control.frames(seed, pt, blk, traffic["batch"], home,
                                devices=devices) for (pt, blk), _ in chosen]
            rec["control"] = compare.numbers(stack(o), rcat)
        rec["window_s"], rec["check_s"] = win_s, time.perf_counter() - t
        rec["ref_bit_errors"] = int(rcat["bit_errors"].sum())
        rec["frames"] = int(rcat["bit_errors"].shape[0])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
