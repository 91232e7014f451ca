"""Small cells of the benchmark's configurations, for runs on the CPU.

`write_tiny(dir, ebno_db)` writes a BENCHMARK.json and its configuration,
traffic and check files into dir: each configuration of the benchmark with
L = 64, M = 64 (and a QC outer code of n = 30 with zero blocks, TINY_QC,
in the 802.11n layout), at ebno_db, blocks of 16 frames, four blocks a
campaign call; `.dp16` on a data mesh of two devices.  The checks take the
limits of the benchmark's cell of the same configuration."""

import json
from pathlib import Path

from benchmark.harness import spec

# Z = 5; an information part and a dual-diagonal parity part whose first
# column carries the anchor shifts, -1 a zero block
TINY_QC = (5, [[1, 0, 3, 1, 0, -1],
               [2, 4, -1, 0, 0, 0],
               [0, -1, 2, 1, -1, 0]])


def write_qc(path: Path, Z: int, shifts) -> None:
    """A base matrix in the port's file format: Z, then a row a line."""
    path.write_text("\n".join([str(Z)] + [" ".join(map(str, r))
                                          for r in shifts]) + "\n")

CELLS = {"tiny_sparc.t16": ("sparc_l1024", "t16"),
         "tiny_concat.t16": ("concat_wifi", "t16"),
         "tiny_sparc.dp16": ("sparc_l1024", "dp16")}


def _limits(bench, config):
    for w in bench["workloads"]:
        if w["config"] == config:
            return spec.cell(w["name"], bench)["check_file"]["limits"]
    raise KeyError(config)


def write_tiny(d: Path, ebno_db: float = 3.0) -> Path:
    d = Path(d)
    for sub in ("configs", "traffic", "workloads"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    bench = spec.benchmark()
    src = spec.PKG_DIR / "configs"
    sp = json.loads((src / "sparc_l1024.json").read_text())
    sp.update(L=64, M=64)
    (d / "configs" / "tiny_sparc.json").write_text(json.dumps(sp))
    cc = json.loads((src / "concat_wifi.json").read_text())
    cc["sparc"].update(L=64, M=64)
    Z, shifts = TINY_QC
    write_qc(d / "tiny.qc", Z, shifts)
    cc["ldpc"].update(path=str(d / "tiny.qc"),
                      qc_base=dict(Z=Z, shifts=shifts))
    cc["f_prot"] = 0.5
    (d / "configs" / "tiny_concat.json").write_text(json.dumps(cc))
    (d / "traffic" / "t16.json").write_text(json.dumps(
        dict(batch=16, ebno_db=ebno_db, blocks_per_call=4)))
    (d / "traffic" / "dp16.json").write_text(json.dumps(
        dict(batch=16, ebno_db=ebno_db, blocks_per_call=4)))
    out = dict(bench, workloads=[])
    for name, (config, traffic) in CELLS.items():
        out["workloads"].append(dict(name=name, config=name.split(".")[0],
                                     traffic=traffic, chips=1, why="tiny"))
        (d / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(check_blocks=2, limits=_limits(bench, config))))
    out["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                        for m in bench["per_layer"]]
    (d / "BENCHMARK.json").write_text(json.dumps(out))
    return d
