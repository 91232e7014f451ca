"""Plain references of the two codes: a trial block decoded from its seed.

`Sparc` is a SPARC (message bits packed MSB first into one section index
per log2(M) bits, section l sent at amplitude sqrt(n P_l)); `Concat` puts
an outer LDPC code on the last Lp sections (num_cw codewords back to back,
num_cw n_ldpc = Lp log2(M) exactly, from f_prot L sections rounded, the
count of codewords lowered until it does), decodes the inner code by AMP,
turns each protected section's posterior into bit LLRs (log of the mass on
the indices whose bit is 0 over the mass where it is 1, each sum floored
at float32's smallest normal), runs BP, takes the channel's hard decision
for a codeword whose syndrome fails, decodes again by AMP with the
sections of the verified codewords pinned, and delivers the unprotected
sections of that pass and the LDPC message bits.

Each takes the configuration's file as a dict and works everything out
again from it: design constants, draws, noise.  `frames` decodes one
block's codewords, `rows` at a time so that the tiles fit beside nothing
else, and returns per-frame results on the host.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import numpy as np
import torch

from . import amp, design, ldpc, seeds


def to_indices(bits: torch.Tensor, logM: int) -> torch.Tensor:
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], -1, logM)
    w = 1 << torch.arange(logM - 1, -1, -1, device=bits.device)
    return (b * w).sum(-1)


def to_bits(idx: torch.Tensor, logM: int) -> torch.Tensor:
    sh = torch.arange(logM - 1, -1, -1, device=idx.device)
    return ((idx.to(torch.int64)[..., None] >> sh) & 1).reshape(
        *idx.shape[:-1], -1)


class Sparc:
    def __init__(self, cfg: Dict, ebno_db: float, device,
                 rounding: str = "bf16"):
        for key, want in (("op_kind", "hadamard"), ("col_signs", False),
                          ("tau_mode", "online")):
            if cfg.get(key, want) != want:
                raise ValueError(f"the reference decodes {key}={want!r} "
                                 f"only")
        self.cfg = cfg
        self.L, self.M = cfg["L"], cfg["M"]
        self.logM = self.M.bit_length() - 1
        self.n = design.code_length(cfg)
        self.s2 = design.sigma2(cfg, ebno_db)
        p = design.power(cfg, self.s2)
        self.T = design.iterations(cfg, p, self.s2)
        self.tol = float(cfg["amp_tol"])
        self.P = float(cfg["P"])
        self.device = torch.device(device)
        self.sq = torch.tensor(np.sqrt(self.n * p).astype(np.float32),
                               device=device)
        self.mask = torch.as_tensor(design.row_mask(cfg), device=device)
        self.tf = amp.Transform(self.L, self.M, device, rounding)

    @property
    def message_bits(self) -> int:
        return self.L * self.logM

    def with_rounding(self, rounding: str) -> "Sparc":
        """The same code, its transforms rounded another way."""
        other = copy.copy(self)
        other.tf = amp.Transform(self.L, self.M, self.device, rounding)
        other._on = {}
        return other

    def on(self, device) -> "Sparc":
        """This reference with its tables on `device`."""
        device = torch.device(device)
        if device == self.device:
            return self
        cache = self.__dict__.setdefault("_on", {})
        if device not in cache:
            other = copy.copy(self)
            other.device = device
            other.sq, other.mask = self.sq.to(device), self.mask.to(device)
            other.tf = copy.copy(self.tf)
            other.tf.HL, other.tf.HM = (self.tf.HL.to(device),
                                        self.tf.HM.to(device))
            other._on = {}
            cache[device] = other
        return cache[device]

    def amp(self, idx, keys, T=None, pin=None):
        return amp.decode(idx, keys, self.mask, self.sq, self.P, self.n,
                          math.sqrt(self.s2), T or self.T, self.tol, self.tf,
                          pin)

    def chunk(self, b: torch.Tensor, k: torch.Tensor) -> Dict:
        """Per-frame results of codewords with message bits b and noise
        keys k, on this reference's device."""
        idx = to_indices(b, self.logM)
        res = self.amp(idx, k)
        hat = res.pop("beta").argmax(-1)
        return dict(bit_errors=(to_bits(hat, self.logM) != b).sum(-1),
                    section_errors=(hat != idx).sum(-1),
                    iters=res["iters"], tau2=res["tau2"])

    def frames(self, base: int, point: int, block: int, batch: int,
               draw_device, rows: int = 512, devices=None
               ) -> Dict[str, np.ndarray]:
        """Per-frame results of block (base, point, block) (`chunk`), its
        codewords decoded `rows` at a time, the chunks taken in turn by
        `devices` (default: this reference's)."""
        return decode_block(self, base, point, block, batch, draw_device,
                            rows, devices)


def decode_block(ref, base, point, block, batch, draw_device, rows,
                 devices) -> Dict[str, np.ndarray]:
    bits, keys = seeds.block_draws(base, point, block, batch,
                                   ref.message_bits, draw_device)
    devs = list(devices or [ref.device])
    parts = []
    for i, r in enumerate(range(0, batch, rows)):
        dev = torch.device(devs[i % len(devs)])
        parts.append(ref.on(dev).chunk(bits[r:r + rows].to(dev),
                                       keys[r:r + rows].to(dev)))
    return {k: torch.cat([p[k].cpu() for p in parts]).numpy()
            for k in parts[0]}


def partition(L: int, logM: int, n_ldpc: int, f_prot: float):
    """(Lu, Lp, num_cw)."""
    target = int(round(f_prot * L)) * logM
    num_cw = target // n_ldpc
    while num_cw > 0 and (num_cw * n_ldpc) % logM:
        num_cw -= 1
    if num_cw == 0:
        raise ValueError("no LDPC codeword fits the protected sections")
    Lp = num_cw * n_ldpc // logM
    return L - Lp, Lp, num_cw


class Concat:
    def __init__(self, cfg: Dict, ebno_db: float, device,
                 rounding: str = "bf16"):
        self.inner = Sparc(cfg["sparc"], ebno_db, device, rounding)
        self.device = self.inner.device
        self.code = ldpc.Code(cfg["ldpc"], device)
        self.Lu, self.Lp, self.num_cw = partition(
            self.inner.L, self.inner.logM, self.code.n, cfg["f_prot"])
        self.feedback_iters = int(cfg["feedback_iters"])
        logM, M = self.inner.logM, self.inner.M
        j = torch.arange(M, device=device)
        bit = (j[:, None] >> torch.arange(logM - 1, -1, -1,
                                          device=device)) & 1
        self.ones = bit.to(torch.float32)             # (M, logM): bit b of j
        self.zeros = 1.0 - self.ones

    @property
    def message_bits(self) -> int:
        return self.Lu * self.inner.logM + self.num_cw * self.code.k

    def with_rounding(self, rounding: str) -> "Concat":
        other = copy.copy(self)
        other.inner = self.inner.with_rounding(rounding)
        other._on = {}
        return other

    def on(self, device) -> "Concat":
        device = torch.device(device)
        if device == self.device:
            return self
        cache = self.__dict__.setdefault("_on", {})
        if device not in cache:
            other = copy.copy(self)
            other.device = device
            other.inner = self.inner.on(device)
            other.code = self.code.on(device)
            other.ones, other.zeros = (self.ones.to(device),
                                       self.zeros.to(device))
            other._on = {}
            cache[device] = other
        return cache[device]

    def true_indices(self, bits: torch.Tensor) -> torch.Tensor:
        B = bits.shape[0]
        nu = self.Lu * self.inner.logM
        msgs = bits[:, nu:].reshape(B * self.num_cw, self.code.k)
        cw = self.code.encode(msgs).reshape(B, -1)
        return to_indices(torch.cat([bits[:, :nu], cw], 1), self.inner.logM)

    def llrs(self, beta: torch.Tensor) -> torch.Tensor:
        """Bit LLRs (B, Lp log2 M) of the protected sections of beta."""
        w = beta[:, self.Lu:, :]
        tiny = torch.finfo(torch.float32).tiny
        s0 = torch.matmul(w, self.zeros).clamp_min(tiny)
        s1 = torch.matmul(w, self.ones).clamp_min(tiny)
        return (torch.log(s0) - torch.log(s1)).reshape(w.shape[0], -1)

    def chunk(self, b: torch.Tensor, k: torch.Tensor) -> Dict:
        """Per-frame bit_errors, iters (the first pass's) and bp_ok (the
        verified codewords), the delivered bits and the message bits sent,
        of frames with message bits b and noise keys k."""
        inner, code = self.inner, self.code
        logM = inner.logM
        B = b.shape[0]
        idx = self.true_indices(b)
        first = inner.amp(idx, k)
        llr = self.llrs(first.pop("beta")).reshape(-1, code.n)
        bp = code.decode(llr)
        hard = torch.where(bp["ok"][:, None], bp["hard"],
                           (llr < 0).to(torch.uint8))
        cw = hard.reshape(B, -1)
        ok = bp["ok"].reshape(B, self.num_cw)
        sec_ok = ok.repeat_interleave(code.n, 1).reshape(
            B, self.Lp, logM).all(-1)
        pin = torch.cat([torch.full((B, self.Lu), -1, device=self.device),
                         torch.where(sec_ok, to_indices(cw, logM), -1)],
                        1).to(torch.int32)
        second = inner.amp(idx, k, T=self.feedback_iters, pin=pin)
        unprot = to_bits(second["beta"][:, :self.Lu].argmax(-1), logM)
        msg = cw.reshape(B * self.num_cw, code.n)[:, code.msg]
        got = torch.cat([unprot, msg.reshape(B, -1).to(torch.int64)], 1)
        return dict(bit_errors=(got != b).sum(-1), iters=first["iters"],
                    bp_ok=ok.sum(-1), bits=got.to(torch.uint8),
                    sent=b.to(torch.uint8))

    def frames(self, base: int, point: int, block: int, batch: int,
               draw_device, rows: int = 512, devices=None
               ) -> Dict[str, np.ndarray]:
        return decode_block(self, base, point, block, batch, draw_device,
                            rows, devices)
