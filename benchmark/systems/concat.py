"""A SPARC + LDPC configuration on the port: `ConcatModel.run_block`, one
trial block (draws, the first AMP pass on K1 with the noise drawn in the
kernel, the LLR fold, BP on K2, the pinned feedback pass on K1, the
counters), on one card or under the data mesh of the campaign CLI.

The benchmark reads, for the blocks it checks, the per-frame results where
the block produces them: the first pass's iterations (`SparcModel.decode`
without T), the verified LDPC codewords (`ConcatModel._bp_from_beta`) and
the delivered message bits (`ConcatModel._feedback_user_bits`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from benchmark.reference import codes, ldpc
from benchmark.systems.sparc import policy_for, wrap_method
from benchmark.systems.sparc import program_config as sparc_config


def program_config(cfg: Dict):
    from sparc_ldpc_tpu_torch.config import ConcatConfig, LdpcConfig

    names = {f.name for f in dataclasses.fields(LdpcConfig)}
    return ConcatConfig(
        sparc=sparc_config(cfg["sparc"]),
        ldpc=LdpcConfig(**{k: v for k, v in cfg["ldpc"].items()
                           if k in names}),
        f_prot=cfg["f_prot"], feedback_iters=cfg["feedback_iters"])


class System:
    def __init__(self, cfg: Dict, traffic: Dict, devices: List):
        from sparc_ldpc_tpu_torch.models.concat import ConcatModel

        self.cfg = cfg
        self.policy = policy_for(devices)
        self.home = devices[0]
        self.model = ConcatModel.build(
            program_config(cfg), traffic["ebno_db"],
            None if self.policy else self.home, policy=self.policy)
        self.run_block = self.model.run_block

    @staticmethod
    def message_bits(cfg: Dict) -> int:
        sp = cfg["sparc"]
        logM = sp["M"].bit_length() - 1
        code = ldpc.Code(cfg["ldpc"], "cpu")
        Lu, _, num_cw = codes.partition(sp["L"], logM, code.n, cfg["f_prot"])
        return Lu * logM + num_cw * code.k

    def capture(self, store) -> None:
        def decode(orig, *args, **kw):
            res = orig(*args, **kw)
            if kw.get("T") is None:
                store.put("iters", res.iters)
            return res

        def bp(orig, *args, **kw):
            out = orig(*args, **kw)
            store.put("bp_ok", out[1])
            return out

        def delivered(orig, *args, **kw):
            out = orig(*args, **kw)
            store.put("bits", out)
            return out

        wrap_method(self.model.sparc, "decode", decode)
        wrap_method(self.model, "_bp_from_beta", bp)
        wrap_method(self.model, "_feedback_user_bits", delivered)

    @staticmethod
    def frames(captured: Dict) -> Dict[str, np.ndarray]:
        return dict(iters=captured["iters"],
                    bp_ok=captured["bp_ok"].sum(-1),
                    bits=captured["bits"].astype(np.uint8))

    @staticmethod
    def reference(cfg: Dict, ebno_db: float, device, rounding: str):
        return codes.Concat(cfg, ebno_db, device, rounding)

