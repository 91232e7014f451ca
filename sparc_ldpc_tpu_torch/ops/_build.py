"""Build the port's CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library, compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `sparc_ldpc_tpu_torch/build/` under a content-addressed file name (an
edited source, or an edited shared header `csrc/*.cuh`, is rebuilt).
`build()` starts one nvcc per missing library, all at once, and waits for
them; `load_library(name)` builds if needed and loads one library; `run`
calls an entry point on a given device.  The
sources have a plain C interface and include no PyTorch header, which
keeps a build to seconds.  Each compiler's output, with ptxas's register
and spill report, is kept in `build/nvcc_<name>.log`.  A missing compiler
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source name -> {entry point: (argtypes, restype)}; every source also
# exports `<name>_error_string(int) -> const char*` for its return codes
_SIGNATURES = {
    "amp_split": {
        "amp_split_run": ((_P,) * 5 + (_I,) + (_P,) * 15 + (_I,) * 4
                          + (_F,) * 5 + (_I, _P), _I),
        "amp_fwht_tile": ((_P, _P, _P, _I, _I, _I, _I, _F, _P), _I),
        "amp_noise_run": ((_P, _P, _F, _P, _I, _I, _I, _P), _I),
        "amp_noise_draws": ((_P, _P, _P, _I, _I, _I, _P), _I),
        "fwht2_run": ((_P, _P, _I, _I, _I, _I, _P), _I),
    },
    "amp_mono": {
        "amp_mono_run": ((_P,) * 7 + (_I,) + (_P,) * 15 + (_I,) * 4
                         + (_F,) * 4 + (_P,), _I),
        "amp_mono_adjoint": ((_P, _P, _I, _P, _I, _I, _I, _P), _I),
    },
    "amp_exp": {
        "amp_exp_run": ((_I,) + (_P,) * 5 + (_I,) + (_P,) * 11 + (_I,) * 4
                        + (_F,) * 3 + (_I, _P), _I),
    },
    "amp_slab_exp": {
        "amp_slab_exp_run": ((_I,) + (_P,) * 7 + (_I,) + (_P,) * 14
                             + (_I,) * 6 + (_F,) * 4 + (_P,), _I),
    },
    "amp_slab": {
        "amp_slab_run": ((_P,) * 7 + (_I,) + (_P,) * 16 + (_I,) * 4
                         + (_F,) * 4 + (_P,), _I),
        "amp_slab_tile": ((_P,) * 3 + (_I,) * 3 + (_P,), _I),
        "amp_slab_adjoint": ((_P, _P, _I, _P, _I, _I, _I, _P), _I),
    },
    "bp_qc_layered": {
        "bp_qc_layered_run": ((_P,) * 8 + (_I,) * 11 + (_F,) * 3 + (_P,), _I),
    },
    "denoise": {
        "denoise_run": ((_P,) * 5 + (_I,) * 3 + (_P,), _I),
    },
}
LIBRARIES = tuple(_SIGNATURES)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def source_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if name not in _SIGNATURES or not src.exists():
        raise RuntimeError(f"no CUDA source {src}")
    return src


def library_path(name: str) -> Path:
    src = source_path(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every library that is missing, one nvcc each, all started
    together; returns the wall seconds."""
    missing = [n for n in LIBRARIES if not library_path(n).exists()]
    if not missing:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for name in missing:
        so = library_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, cmd, proc))
    failed = []
    for name, so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"nvcc_{name}.log").write_text(" ".join(cmd) + "\n"
                                                    + out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} ({proc.returncode}):\n{out[-4000:]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load library `name` and declare its entry
    points."""
    if not library_path(name).exists():
        build()
    lib = ctypes.CDLL(str(library_path(name)))
    sigs = dict(_SIGNATURES[name])
    sigs[f"{name}_error_string"] = ((_I,), ctypes.c_char_p)
    for fn_name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(name: str, rc: int, what: str) -> None:
    """Raise if an entry point of library `name` returned an error code."""
    if rc != 0:
        msg = getattr(load_library(name), f"{name}_error_string")(rc)
        raise RuntimeError(f"{what} failed: {msg.decode()} (code {rc})")


def run(name: str, entry: str, device, *args) -> None:
    """Call entry point `entry` of library `name` with args and the current
    stream of `device` (a CUDA device), which is the current CUDA device
    for the call: a kernel launches on the current device, whatever stream
    it is given.  Raises on an error code."""
    import torch

    with torch.cuda.device(device):
        rc = getattr(load_library(name), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(name, rc, entry)
