"""Artifact provenance (port of sparc_ldpc_tpu/utils/provenance.py).

Every persisted results record carries the preset name, a hash of the
exact config that produced it, the source commit, and here also the
backend, the device and the torch version, so a reader can tell whether an
artifact still describes the shipped preset and where it ran.  The configs
are the reference's frozen dataclasses with a deterministic repr, so
sha1(repr) is a stable fingerprint across processes and equal to the
reference's for the same config.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
from typing import Optional

import torch


def config_hash(cfg: object) -> str:
    """12-hex fingerprint of a (frozen, repr-stable) config object."""
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


# Config fields added after artifacts were written whose default keeps the
# earlier behavior; an artifact hashed before such a field existed still
# describes the config while the field holds its default.
_DEFAULT_PRESERVING = ("amp_noise_in_kernel",)


def _repr_without_default_fields(cfg: object, skip: tuple) -> str:
    """Dataclass repr with `skip` fields elided wherever they hold their
    declared default (recursing into nested dataclass fields)."""
    if not dataclasses.is_dataclass(cfg):
        return repr(cfg)
    parts = []
    for f in dataclasses.fields(cfg):
        if not f.repr:
            continue
        v = getattr(cfg, f.name)
        if f.name in skip and v == f.default:
            continue
        vr = (_repr_without_default_fields(v, skip)
              if dataclasses.is_dataclass(v) else repr(v))
        parts.append(f"{f.name}={vr}")
    return f"{type(cfg).__name__}({', '.join(parts)})"


def config_hashes(cfg: object) -> set:
    """Current fingerprint plus the legacy one of the repr without the
    default-preserving fields."""
    legacy = _repr_without_default_fields(cfg, _DEFAULT_PRESERVING)
    return {config_hash(cfg), hashlib.sha1(legacy.encode()).hexdigest()[:12]}


def git_commit() -> Optional[str]:
    """Short HEAD commit of the source tree, or None outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def artifact_meta(preset: str, cfg: object,
                  device: Optional[torch.device] = None) -> dict:
    """Provenance fields to merge into every results record.  `commit` is
    always present: None where the source is not a git checkout."""
    device = torch.device("cpu") if device is None else torch.device(device)
    meta = dict(preset=preset, config_hash=config_hash(cfg),
                backend=f"torch-{device.type}", torch=torch.__version__)
    if device.type == "cuda":
        meta["device"] = torch.cuda.get_device_name(device)
    else:
        meta["device"] = "cpu"
    meta["commit"] = git_commit()
    return meta
