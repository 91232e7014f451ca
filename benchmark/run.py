"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

One process: load the cell (BENCHMARK.json and the files it names under
benchmark/), build the port's model on the cell's cards, warm up with a
campaign call at the cell's batch, then drive the campaign's pipelined
dispatch (`run_point`) for --seconds, call after call.  Untraced, the run
reports the cell's end-to-end metrics; traced (torch.profiler over the
window), its per-layer metrics, with the device's busy time and a
breakdown.  After the window it frees the program's state and decodes the
checked blocks again with the plain reference (benchmark/reference), from
the same seed; `correct` holds each compared number to its limit
(benchmark/workloads/<cell>.json).  The last line of standard output is one
JSON object; the compared numbers end standard error too.

Without CUDA, or with fewer cards than the cell asks for, it exits with 2
and prints no result; so it does if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark.harness import spec, window  # noqa: E402
from benchmark.harness.timeline import WINDOW, Timeline  # noqa: E402
from benchmark.reference import compare  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sparc_ldpc_tpu")
SEED_SPACE = 1 << 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_lines():
    """nvidia-smi's name and power limit of each card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        return None


def draw_sample(seed: int, n: int, calls: int, per_call: int):
    """n distinct (call, block) positions drawn from the seed, the calls
    among the first `calls`."""
    rng = np.random.default_rng([seed, 0x5A3])
    out = set()
    while len(out) < min(n, calls * per_call):
        out.add((int(rng.integers(calls)), int(rng.integers(per_call))))
    return out


def read_metrics(entries, run):
    out = {}
    for m in entries:
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def malformed(row, batch: int, bits: int) -> bool:
    vals = [row.get(k) for k in window.COUNTERS if k in row]
    if any(v is None or not np.isfinite(v) or v < 0 or v != int(v)
           for v in vals):
        return True
    return (row.get("trials") != batch
            or row.get("frame_errors", 0) > batch
            or row.get("bit_errors", 0) > batch * bits)


def frame_sums(frames, ref):
    """The block counters that a block's per-frame outputs imply."""
    out = {"iters_sum": int(np.sum(frames["iters"], dtype=np.int64))}
    be = (frames["bits"] != ref["sent"]).sum(-1) if "bits" in frames \
        else frames["bit_errors"]
    out["bit_errors"] = int(np.sum(be, dtype=np.int64))
    out["frame_errors"] = int(np.sum(be > 0))
    for k in ("section_errors", "bp_ok"):
        if k in frames:
            out[k] = int(np.sum(frames[k], dtype=np.int64))
    return out


def cards(cell):
    """The cell's cards, or None (and why, on standard error) where this
    machine lacks them."""
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return None
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return None
    return [torch.device("cuda", i) for i in range(cell["chips"])]


def prepare(cfg, traffic, devices, seed: int):
    """The configuration's program on devices, as the campaign CLI sets it
    up, warmed up by one campaign call of two blocks at the cell's batch:
    (system module, system, capture, marks, seconds a warm block)."""
    import torch

    home = devices[0]
    if home.type == "cuda":
        torch.cuda.set_device(home)
    # the campaign CLI's setting on the GPUs: float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sysmod = spec.system(cfg["system"])
    t = time.perf_counter()
    system = sysmod.System(cfg, traffic, devices)
    log(f"setup: process start to the build {t - T_START:.3f} s, the "
        f"model's build {time.perf_counter() - t:.3f} s")
    capture = window.Capture()
    system.capture(capture)
    marks = window.Marks(home)
    t = time.perf_counter()
    warm = window.drive(system, traffic, 0, seed, marks, capture, None,
                        devices, point0=window.WARM_POINT, calls=1,
                        per_call=2)
    if warm.error:
        raise RuntimeError(f"warm-up failed: {warm.error}")
    block_s = (time.perf_counter() - t) / len(warm.blocks)
    log(f"setup: warm-up call {time.perf_counter() - t:.3f} s "
        f"({len(warm.blocks)} blocks)")
    return sysmod, system, capture, marks, block_s


def main(argv=None, devices=None) -> int:
    """One run.  devices None: the cell's cards, which must exist (the
    benchmark); a list runs there without that look (tests)."""
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch

    t = time.perf_counter()
    if devices is None:
        devices = cards(cell)
        if devices is None:
            return 2
    devices = [torch.device(d) for d in devices]
    home = devices[0]
    log(f"setup: imports {t - T_START:.3f} s, the cards' look "
        f"{time.perf_counter() - t:.3f} s")
    seed = args.seed % SEED_SPACE
    cfg, traffic, checks = (cell["config_file"], cell["traffic_file"],
                            cell["check_file"])
    B, per_call = traffic["batch"], traffic["blocks_per_call"]
    log(f"cell {args.workload} seed {args.seed} on "
        f"{[str(d) for d in devices]}")
    sysmod, system, capture, marks, block_s = prepare(cfg, traffic,
                                                      devices, seed)
    bits = sysmod.System.message_bits(cfg)
    roofs = spec.rooflines()
    calls = window.Calls(roofs)
    journal = os.path.join(tempfile.gettempdir(),
                           f"benchmark.{args.workload}.{seed}.journal")
    est_calls = max(1, int(0.7 * args.seconds / (per_call * block_s)))
    capture.sample = draw_sample(seed, checks["check_blocks"], est_calls,
                                 per_call)

    prof = None
    if args.trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA]
               if home.type == "cuda" else []))
        prof.__enter__()
    if os.path.exists(journal):
        os.remove(journal)
    setup = {}

    def on_start():
        setup["s"] = time.perf_counter() - T_START
        calls.on = True

    with torch.profiler.record_function(WINDOW):
        w = window.drive(system, traffic, args.seconds, seed, marks, capture,
                         journal, devices, on_start=on_start)
    calls.on = False
    if os.path.exists(journal):
        os.remove(journal)
    timeline = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(tempfile.gettempdir(),
                            f"benchmark.{args.workload}.{seed}.trace.json")
        prof.export_chrome_trace(path)
        timeline = Timeline.load(path)
        os.remove(path)
        del prof

    # read once the window has closed: no request waits for it
    card_list = card_lines() if home.type == "cuda" else None
    rows, block_ms = window.counters(w, marks)
    failed = sum(malformed(r, B, bits) for r in rows) + (1 if w.error else 0)
    attempted = len(rows) + (1 if w.error else 0)
    if w.error:
        log(f"a block raised: {w.error}")
    peak = max(torch.cuda.max_memory_reserved(d) for d in devices) \
        if home.type == "cuda" else 0
    run = types.SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, message_bits=bits,
        setup_s=setup["s"], window_s=w.t1 - w.t0, blocks=rows,
        block_ms=block_ms, timeline=timeline, calls=calls.recs,
        rooflines=roofs, devices=[d.index or 0 for d in devices], log=log)
    metrics = read_metrics(spec.metrics_for(args.workload, bench,
                                            bool(args.trace)), run)
    device = {"platform": "gpu" if home.type == "cuda" else home.type,
              "kind": (torch.cuda.get_device_name(home)
                       if home.type == "cuda" else home.type),
              "count": len({str(d) for d in devices}),
              "memory_peak_bytes": int(peak)}
    if card_list:
        device["cards"] = card_list
    breakdown = None
    if timeline is not None:
        busy = [timeline.busy_seconds(i) for i in run.devices]
        device.update(busy_s=sum(busy) / len(busy),
                      window_s=timeline.seconds())
        breakdown = {"device_ops": timeline.top_device_ops(10),
                     "idle_gaps": timeline.top_idle_gaps(run.devices[0], 10)}
    log(f"{len(rows)} blocks in {run.window_s:.3f} s over {w.points} "
        f"campaign calls; setup {run.setup_s:.3f} s; peak "
        f"{peak / 2 ** 30:.2f} GiB")

    # the program's state goes before the reference runs
    chosen = [(pos, window.to_host(c)) for pos, c in capture.chosen()]
    counters_at = {(r["point"], r["block"]): r for r in rows}
    calls.restore()
    del system, capture, calls, w, run
    if home.type == "cuda":
        torch.cuda.empty_cache()

    correct, values, bad = check(sysmod, cfg, traffic, checks, seed,
                                 chosen, counters_at, devices)
    failed += bad
    correct = correct and failed == 0 and not forbidden_modules()
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 2
    limits = checks["limits"]
    for k, lim in limits.items():
        log(f"check {k} {values[k]!r} limit {lim!r}")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": values[k], "limit": limits[k]}
                        for k in limits}
    print(json.dumps(result), flush=True)
    return 0


def stack(frames):
    """Per-frame outputs of several blocks, end to end."""
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


def judge(ref, sysmod, traffic, seed, chosen, counters_at, devices):
    """Decode the checked blocks with the reference `ref` (on the run's
    cards, their codewords shared out in turn) and hold the program's
    per-frame outputs to it: (the numbers of compare.numbers, the count of
    blocks whose counters disagree with their own frames, the reference's
    frames)."""
    prog, refs, bad = [], [], 0
    for (point, block), cap in chosen:
        r = ref.frames(seed, point, block, traffic["batch"], devices[0],
                       devices=devices)
        f = sysmod.System.frames(cap)
        sums = frame_sums(f, r)
        row = counters_at[(point, block)]
        if any(row.get(k) != v for k, v in sums.items() if k in row):
            log(f"block ({point}, {block}): counters {row} against its "
                f"frames' {sums}")
            bad += 1
        prog.append(f)
        refs.append(r)
    rcat = stack(refs)
    return compare.numbers(stack(prog), rcat), bad, rcat


def check(sysmod, cfg, traffic, checks, seed, chosen, counters_at,
          devices):
    """(correct, the numbers, the malformed blocks) of the checked blocks
    against the reference in the configuration's rounding."""
    ref = sysmod.System.reference(cfg, traffic["ebno_db"], devices[0],
                                  "bf16")
    values, bad, _ = judge(ref, sysmod, traffic, seed, chosen, counters_at,
                           devices)
    ok = compare.verdict(values, checks["limits"])
    return ok and bad == 0, values, bad


if __name__ == "__main__":
    sys.exit(main())
