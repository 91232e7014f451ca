"""A SPARC configuration on the port: `SparcModel.run_block`, one trial
block of B codewords (draws, encode and noise in K1, the AMP decode, the
counters), on one card or, with several devices, under the data mesh that
the campaign CLI builds when its process sees them.

The benchmark reads the block's per-frame results where the block produces
them, `SparcModel.frame_counts` (bit and section errors, iterations and the
last tau2 of each frame), for the blocks it checks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from benchmark.reference import codes


def program_config(cfg: Dict):
    from sparc_ldpc_tpu_torch.config import SparcConfig

    names = {f.name for f in dataclasses.fields(SparcConfig)}
    return SparcConfig(**{k: v for k, v in cfg.items() if k in names})


def policy_for(devices: List):
    """The campaign CLI's policy for one process driving `devices`: none
    on one device, else the data mesh (devices x 1)."""
    if len(devices) == 1:
        return None
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    return ShardingPolicy.for_process(make_mesh(1, devices))


def wrap_method(obj, name: str, fn) -> None:
    """obj.name becomes fn(original, *args, **kw) on this instance."""
    orig = getattr(obj, name)

    def wrapped(*args, **kw):
        return fn(orig, *args, **kw)

    object.__setattr__(obj, name, wrapped)


class System:
    def __init__(self, cfg: Dict, traffic: Dict, devices: List):
        from sparc_ldpc_tpu_torch.models.sparc import SparcModel

        self.cfg = cfg
        self.policy = policy_for(devices)
        self.home = devices[0]
        self.model = SparcModel.build(
            program_config(cfg), traffic["ebno_db"],
            None if self.policy else self.home, policy=self.policy)
        self.run_block = self.model.run_block

    @staticmethod
    def message_bits(cfg: Dict) -> int:
        return cfg["L"] * (cfg["M"].bit_length() - 1)

    def capture(self, store) -> None:
        def frame_counts(orig, *args, **kw):
            out = orig(*args, **kw)
            store.put("frames", out)
            return out

        wrap_method(self.model, "frame_counts", frame_counts)

    @staticmethod
    def frames(captured: Dict) -> Dict[str, np.ndarray]:
        f = captured["frames"]
        return dict(bit_errors=f["bit_errors"], section_errors=f[
            "section_errors"], iters=f["iters"], tau2=f["tau2_final"])

    @staticmethod
    def reference(cfg: Dict, ebno_db: float, device, rounding: str):
        return codes.Sparc(cfg, ebno_db, device, rounding)
