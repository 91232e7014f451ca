"""LDPC code on a device: encoder and BP tables (port of
sparc_ldpc_tpu/models/ldpc.py `LdpcModel`).

Construction and GF(2) systematization are host-side (design/ldpc_codes.py,
the port's copy of the reference's); this module puts the results on a
device: the generator for the encode product, the padded edge tables
(ops.bp) and, for quasi-cyclic codes, the circulant tables (ops.bp_qc) and
base matrix (ops.bp_qc_kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import check_device
from ..config import LdpcConfig
from ..design.ldpc_codes import LdpcCode, build_code, qc_structure
from ..ops.bp import BpResult, BpTables, bp_decode
from ..ops.bp_qc import QcBpTables, bp_decode_qc
from ..ops.bp_qc_kernel import bp_decode_qc_kernel
from ..utils.profiling import annotate, count


@dataclass(frozen=True)
class LdpcModel:
    cfg: LdpcConfig
    code: LdpcCode                  # host truth (numpy)
    G: torch.Tensor                 # (k, n) float32 0/1 generator
    H: torch.Tensor                 # (m, n) uint8 parity-check matrix
    tables: BpTables
    msg_pos: torch.Tensor           # (k,) int64 message positions
    device: torch.device
    qc_tables: Optional[QcBpTables] = None
    qc_shifts: Optional[tuple] = None   # (J, K) base matrix as tuples

    @staticmethod
    def build(cfg: LdpcConfig, device=None) -> "LdpcModel":
        """The code on `device` (None: `default_device()`)."""
        device = check_device(device)
        code = build_code(cfg)
        qc = qc_structure(cfg)
        if cfg.engine in ("qc", "qc_xla") and qc is None:
            raise ValueError(f"bp engine {cfg.engine!r} needs a QC code, "
                             f"got kind={cfg.kind!r}")
        return LdpcModel(
            cfg=cfg, code=code,
            G=torch.as_tensor(code.G, dtype=torch.float32, device=device),
            H=torch.as_tensor(code.H, dtype=torch.uint8, device=device),
            tables=BpTables.build(code, device),
            msg_pos=torch.as_tensor(code.message_positions,
                                    dtype=torch.int64, device=device),
            device=device,
            qc_tables=(QcBpTables.build(*qc, device=device)
                       if qc is not None else None),
            qc_shifts=(tuple(tuple(int(s) for s in row) for row in qc[0])
                       if qc is not None else None))

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def n(self) -> int:
        return self.code.n

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, k) {0,1} -> (B, n) int32 systematic codewords.

        The product of 0/1 matrices in float32 is exact (every sum is an
        integer <= k < 2^24; TF32 would round only the 0/1 inputs, which
        it keeps exact), then mod 2.  CUDA has no int32 matmul."""
        prod = bits.to(torch.float32) @ self.G
        return prod.to(torch.int32) % 2

    def decode(self, llr: torch.Tensor, iters: Optional[int] = None
               ) -> BpResult:
        """BP of the codewords llr (N, n); while tracing, their iterations
        count into `bp.iters` and N into `bp.codewords`."""
        with annotate("bp.decode"):
            res = self._decode(llr, iters)
        count("bp.iters", res.iters)
        count("bp.codewords", llr.shape[0])
        return res

    def _decode(self, llr: torch.Tensor, iters: Optional[int]) -> BpResult:
        cfg = self.cfg
        iters = iters or cfg.bp_iters
        use_qc = (cfg.engine in ("qc", "qc_xla")
                  or (cfg.engine == "auto" and self.qc_tables is not None))
        if use_qc:
            # engine="qc" layered min-sum / offset min-sum on the GPU
            # launches the hand-written kernel, bitwise equal to the plain
            # layered engine; "qc_xla" pins the plain engine
            if (cfg.engine == "qc" and cfg.schedule == "layered"
                    and cfg.decoder in ("minsum", "oms")
                    and self.qc_shifts is not None and llr.is_cuda):
                return bp_decode_qc_kernel(
                    llr, self.qc_shifts, self.qc_tables.Z, iters=iters,
                    method=cfg.decoder, alpha=cfg.alpha, beta=cfg.beta,
                    clip=cfg.llr_clip)
            return bp_decode_qc(llr, self.qc_tables, iters=iters,
                                method=cfg.decoder, alpha=cfg.alpha,
                                beta=cfg.beta, clip=cfg.llr_clip,
                                schedule=cfg.schedule)
        return bp_decode(llr, self.tables, iters=iters, method=cfg.decoder,
                         alpha=cfg.alpha, beta=cfg.beta, clip=cfg.llr_clip)

    def extract_message(self, codeword_bits: torch.Tensor) -> torch.Tensor:
        """(B, n) -> (B, k) message bits at the systematic positions."""
        return codeword_bits.index_select(-1, self.msg_pos)
