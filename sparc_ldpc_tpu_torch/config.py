"""The port's own copy of sparc_ldpc_tpu/config.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

Typed, hashable configuration objects for the SPARC/LDPC framework.

Design contract: SURVEY.md §2 (component 1) and Appendix A.1.  All configs are
frozen dataclasses so they can be passed as `static_argnums` to `jax.jit` and
used as dict keys for compilation caches.  Everything derivable (code length
``n``, bits per section, total rate bits) is exposed as cached properties that
are pure functions of the config.

Conventions (SURVEY.md App. A.1):
  - L sections, M columns per section (M a power of two), rate R in
    bits/channel-use, total power P, noise variance sigma2.
  - code length  n = L * log2(M) / R   (rounded to nearest int).
  - Eb/N0 = P / (2 * R * sigma2)  for the real AWGN channel (N0 = 2 sigma2).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclass(frozen=True)
class SparcConfig:
    """Static description of a SPARC codebook (SURVEY.md App. A.1/A.3).

    Attributes:
      L: number of sections.
      M: columns per section (power of two); log2(M) bits are carried per
        section.
      R: rate in bits per (real) channel use.  The *overall* user rate when an
        LDPC outer code is concatenated is R * ldpc_rate over protected bits.
      P: total average codeword power, E||x||^2 / n == P.
      power_alloc: one of "flat", "exp", "modified", "iterative"
        (SURVEY.md App. A.2).
      pa_a, pa_f: parameters of the modified-exponential allocation
        P_l ∝ 2^{-2 a C l / L} for l <= f L, constant after.  Ignored for
        other allocations. ``None`` means "numerically optimized at build
        time" for the "modified" kind.
      op_kind: measurement operator family: "dense" (explicit Gaussian,
        oracle/small-L only), "hadamard" (matrix-free partial Walsh-Hadamard)
        or "dct" (matrix-free subsampled DCT).  SURVEY.md App. A.3.
      op_seed: host-side seed fixing the operator's random row subset.  Part
        of the code definition: oracle and TPU paths derive identical
        operators from it.
      col_signs: optionally pre-multiply columns by a seeded Rademacher
        diagonal (extra randomization; off by default to follow the
        pyfht-lineage construction, SURVEY.md §2 #9).
      amp_iters: max AMP iterations T.
      amp_tol: early-stop threshold eps: stop when |tau2_t - tau2_{t-1}|
        < eps * tau2_t (SURVEY.md App. A.5).
      tau_mode: "online" (tau2_t = ||z_t||^2 / n) or "se" (precomputed
        state-evolution schedule).
      transform_precision: MXU precision for the fast transforms —
        "highest" | "high" | "default" | "bf16" (ops.fwht.fwht_mxu).
        "high" (3-pass f32) is accuracy-safe; "bf16" halves HBM traffic and
        is validated for BER parity in tests/test_precision.py.
    """

    L: int = 256
    M: int = 512
    R: float = 1.0
    P: float = 1.0
    power_alloc: str = "flat"
    pa_a: Optional[float] = None
    pa_f: Optional[float] = None
    op_kind: str = "hadamard"
    op_seed: int = 0
    col_signs: bool = False
    amp_iters: int = 32
    amp_tol: float = 1e-6
    tau_mode: str = "online"
    transform_precision: str = "high"
    # "mxu" (moveaxis between mode contractions) measured FASTER than the
    # transpose-free "rev" scheme on v5e (422 vs 461 ms/block at bf16 —
    # docs/PERF.md A/B table): XLA fuses the transposes into the dots better
    # than the penultimate-dim contraction form lowers.  Keep both.
    fwht_scheme: str = "mxu"   # "mxu" | "rev"
    # transform backend under a section-sharded mesh: "gspmd" lets XLA shard
    # the mode contractions from the NamedShardings; "collective" uses the
    # hand hypercube-ppermute FWHT (parallel.dist_fwht) — the explicit
    # ring-attention-analog path (SURVEY.md §5), A/B-able per config.
    fwht_dist: str = "gspmd"   # "gspmd" | "collective"
    # Residual domain for AMP with fast-transform operators.  "N" keeps z in
    # the transform domain (no gather/scatter) but carries a (B, N) state
    # through the early-stop freeze mask — measured SLOWER on v5e (469 vs
    # 422 ms/block, docs/PERF.md); "n" is the default.
    amp_residual_space: str = "n"   # "n" | "N"
    # "fused" runs the whole-AMP Pallas mega-kernel (all T iterations per
    # codeword in VMEM, ops/amp_kernel.py) when the operator is eligible
    # (ML == N, L,M <= 1024, online tau, no pinning); falls back to the XLA
    # scan otherwise.  Fixed-T semantics: pair with amp_tol=0 for trace
    # reproducibility.
    # "fused_split" forces the 3-factor split transform (H_L = H_fa (x)
    # H_fb) even at L <= 1024 — ~2.4x fewer transform FLOPs; A/B it per
    # config (docs/PERF.md).
    amp_kernel: str = "xla"   # "xla" | "fused" | "fused_split" | "fused_slab"
    # In-kernel encode (round 3): on the fused single-device path,
    # run_block passes the true section indices + embedded noise and the
    # kernel synthesizes x = A beta0 itself — the XLA one-hot + encode
    # FWHT (24% of headline block wall) disappear.  Same math and RNG
    # draws; x differs from the XLA encode only in bf16 rounding
    # association.  Set False to force the XLA encode (e.g. for
    # bitwise-identical cross-route comparisons at tol > 0).
    amp_encode_in_kernel: bool = True
    # In-kernel noise (round 4): with in-kernel encode on the split
    # kernel, the one remaining (B, L, M) HBM materialization of the
    # trial path is the embedded channel noise (measured 14.7% of
    # headline block wall — scripts/noise_probe.py).  When True, the
    # kernel draws the masked AWGN itself (pltpu per-core PRNG seeded
    # per codeword from the trial key + both-output Box-Muller;
    # ops/amp_kernel.boxmuller_pair_f32 — the single-output variant
    # measured net zero).  Distribution-identical to the jax.random
    # stream but DIFFERENT draws, so cross-route counters are only
    # statistically (not bitwise) comparable.  Since round 5 the fused
    # shipped presets (fast_l4096, concat family) opt IN: the stream is
    # anchored against the float64 oracle by CI-enforced parity legs
    # (kind="tpu_noisek" for plain_small/pa_l1024 fused variants; the
    # concat/fast_l4096 kind="tpu" legs ride it directly —
    # tests/test_ber_parity.py).  Requires amp_encode_in_kernel + the
    # split form + a real TPU (the Pallas interpreter has no PRNG
    # lowering; CPU backends fall back to the XLA noise path).
    amp_noise_in_kernel: bool = False
    # SE-derived per-point iteration budget (SURVEY.md §7 hard-part 4,
    # round-1 VERDICT item 8): when True, SparcModel.build shrinks
    # amp_iters to design.se.se_converged_iters(tol=amp_auto_tol,
    # margin=amp_auto_margin) for its operating point — sweep batches are
    # SNR-homogeneous, so a converged SE trajectory bounds every codeword
    # in the block.  amp_iters acts as the cap.
    amp_iters_auto: bool = False
    amp_auto_tol: float = 1e-4
    amp_auto_margin: int = 2

    def __post_init__(self):
        if not _is_pow2(self.M):
            raise ValueError(f"M must be a power of two, got {self.M}")
        if self.power_alloc not in ("flat", "exp", "modified", "iterative"):
            raise ValueError(f"unknown power_alloc {self.power_alloc!r}")
        if self.op_kind not in ("dense", "hadamard", "dct"):
            raise ValueError(f"unknown op_kind {self.op_kind!r}")
        if self.tau_mode not in ("online", "se"):
            raise ValueError(f"unknown tau_mode {self.tau_mode!r}")
        if self.transform_precision not in ("highest", "high", "default",
                                            "bf16"):
            raise ValueError(
                f"unknown transform_precision {self.transform_precision!r}")
        if self.fwht_scheme not in ("mxu", "rev"):
            raise ValueError(f"unknown fwht_scheme {self.fwht_scheme!r}")
        if self.fwht_dist not in ("gspmd", "collective"):
            raise ValueError(f"unknown fwht_dist {self.fwht_dist!r}")
        if self.amp_residual_space not in ("n", "N"):
            raise ValueError(
                f"unknown amp_residual_space {self.amp_residual_space!r}")
        if self.amp_kernel not in ("xla", "fused", "fused_split", "fused_slab"):
            raise ValueError(f"unknown amp_kernel {self.amp_kernel!r}")

    @property
    def logM(self) -> int:
        return self.M.bit_length() - 1

    @property
    def k_bits(self) -> int:
        """Total message bits per codeword (before any outer-code reduction)."""
        return self.L * self.logM

    @property
    def n(self) -> int:
        """Real channel uses per codeword: n = L log2(M) / R."""
        return int(round(self.L * self.logM / self.R))

    @property
    def ML(self) -> int:
        return self.L * self.M

    def sigma2(self, ebno_db: float) -> float:
        """Noise variance at a given Eb/N0 (dB): sigma2 = P/(2 R_eff EbN0).

        Uses the *actual* rate k_bits/n (equal to R up to the rounding of n).
        """
        ebno = 10.0 ** (ebno_db / 10.0)
        rate = self.k_bits / self.n
        return self.P / (2.0 * rate * ebno)

    def ebno_db(self, sigma2: float) -> float:
        rate = self.k_bits / self.n
        return 10.0 * math.log10(self.P / (2.0 * rate * sigma2))

    @property
    def snr_capacity(self) -> Tuple[float, float]:
        """(snr, Shannon capacity in bits/use) at sigma2 == P/snr ... helper."""
        # capacity for snr = P/sigma2 is computed by callers per sigma2; this
        # property intentionally returns placeholders for introspection only.
        return (float("nan"), float("nan"))

    def replace(self, **kw) -> "SparcConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LdpcConfig:
    """Outer LDPC code configuration (SURVEY.md §2 #16-19, App. A.6).

    The reference's exact code identity is unverifiable (SURVEY.md §0), so the
    code is pluggable: either a named built-in construction or an alist file.

    Attributes:
      kind: "array" (deterministic array/QC-LDPC: H[j,l] = circulant shift
        j*l mod Z, Z prime), "regular" (seeded PEG-like (dv,dc)-regular),
        "alist" (load from path), or "qc" (generic QC base-matrix file at
        `path` — the publication format of the 802.11n/802.16e families,
        SURVEY.md §2 #16).
      z: circulant size for "array" (prime).
      rows_b, cols_b: base-matrix dimensions for "array" (J x K circulant
        blocks -> (J*Z, K*Z) binary H).
      dv, dc: variable/check degrees for "regular".
      n_bits: code length for "regular".
      seed: construction seed for "regular".
      path: alist path for "alist".
      decoder: "minsum" (normalized min-sum), "oms" (offset min-sum) or
        "spa" (sum-product).
      alpha: min-sum normalization factor (App. A.6; 0.8-0.9 typical).
      beta: offset for "oms" (App. A.6).
      bp_iters: max flooding iterations.
      llr_clip: LLR clipping bound for f32 stability.
      engine: BP message layout — "edge" (padded-dense adjacency, any H;
        ops.bp), "qc" (circulant (B,J,K,Z) tensors, QC codes only), or
        "auto" (qc when the code is quasi-cyclic).  Flooding messages
        are engine-identical (parity-tested); pick per config from
        on-chip A/B (docs/PERF.md).  Since round 5, "qc" layered
        minsum/oms decodes on TPU backends route to the whole-decode-
        in-VMEM Pallas kernel (ops/bp_qc_pallas.py: static rolls
        instead of gathers, trace-time block sparsity) — an
        implementation detail, valid because its outputs are BITWISE
        equal to the XLA graph (tests/test_ldpc_qc.py asserts it);
        "qc_xla" pins the XLA implementation for A/B and fallback.
      schedule: "flooding" or "layered" (row-layered MPA, ~2x fewer
        iterations; requires the qc engine).
    """

    kind: str = "array"
    z: int = 31
    rows_b: int = 4
    cols_b: int = 24
    dv: int = 3
    dc: int = 6
    n_bits: int = 1296
    seed: int = 0
    path: Optional[str] = None
    decoder: str = "minsum"
    alpha: float = 0.8125
    beta: float = 0.15
    bp_iters: int = 64
    llr_clip: float = 20.0
    engine: str = "edge"
    schedule: str = "flooding"

    def __post_init__(self):
        if self.kind not in ("array", "regular", "alist", "qc"):
            raise ValueError(f"unknown ldpc kind {self.kind!r}")
        if self.decoder not in ("minsum", "oms", "spa"):
            raise ValueError(f"unknown decoder {self.decoder!r}")
        if self.engine not in ("edge", "qc", "qc_xla", "auto"):
            raise ValueError(f"unknown bp engine {self.engine!r}")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown bp schedule {self.schedule!r}")
        if self.schedule == "layered" and self.engine == "edge":
            raise ValueError("layered schedule requires the qc engine")

    def replace(self, **kw) -> "LdpcConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ConcatConfig:
    """SPARC+LDPC concatenation (SURVEY.md App. A.7).

    Sections are partitioned: the first (1-f_prot)*L are unprotected, the
    last f_prot*L carry LDPC codeword bits.  After BP hardening, a
    decision-feedback AMP pass re-runs with protected sections pinned.
    """

    sparc: SparcConfig = SparcConfig()
    ldpc: LdpcConfig = LdpcConfig()
    f_prot: float = 0.5
    feedback_iters: int = 8

    def replace(self, **kw) -> "ConcatConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CampaignConfig:
    """Monte-Carlo BER/FER campaign (SURVEY.md App. A.8, §3.5).

    Attributes:
      ebno_grid_db: Eb/N0 sweep points in dB.
      batch: codewords per trial block (sharded over the 'data' mesh axis).
      min_frame_errors: stop a point once this many frame errors observed.
      max_trials: hard trial cap per point.
      base_seed: root of the fold_in key tree
        (base, point, host, block) — SURVEY.md §7 hard-part 5.
      data_axis/section_axis: mesh axis names.
      section_shards: how many ways to shard the section axis (1 = pure DP).
    """

    ebno_grid_db: Tuple[float, ...] = (1.5, 2.0, 2.5, 3.0)
    batch: int = 64
    min_frame_errors: int = 100
    max_trials: int = 100_000
    base_seed: int = 1234
    data_axis: str = "data"
    section_axis: str = "section"
    section_shards: int = 1

    def replace(self, **kw) -> "CampaignConfig":
        return dataclasses.replace(self, **kw)


# The five judged configurations from BASELINE.json:7-11 (see BASELINE.md).
PRESETS = {
    # 1. plain SPARC, AMP, L=256 M=512, flat power, Eb/N0=2dB (CPU-size)
    "plain_small": SparcConfig(L=256, M=512, R=1.0, power_alloc="flat",
                               op_kind="hadamard"),
    # 2. power-allocated SPARC L=1024, SE-derived allocation
    "pa_l1024": SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                            op_kind="hadamard"),
    # 3. fast-transform SPARC, L=4096 (matrix-free operator stress config)
    # large-L perf config rides the fused split kernel (VPU-outer stage;
    # 8.2 Mbit/s vs ~2.5 ms per codeword-iteration on the XLA path)
    # amp_noise_in_kernel (round 5): the fused presets ship the in-kernel
    # AWGN stream the headline bench runs (+4.4% headline, +2.2% L=4096,
    # +1.5% concat) — oracle-anchored by the round-5 parity legs.
    # plain_small/pa_l1024 ship the XLA kernel route where the flag
    # cannot engage; their fused_split variants are anchored by the
    # kind="tpu_noisek" parity legs instead.
    "fast_l4096": SparcConfig(L=4096, M=512, R=1.5, power_alloc="iterative",
                              op_kind="hadamard", amp_kernel="fused",
                              amp_tol=1e-4, transform_precision="bf16",
                              amp_noise_in_kernel=True),
    # 4. concatenated SPARC+LDPC (see ConcatConfig defaults).  BOTH AMP
    # passes ride the fused split kernel since round 2: the pinned
    # decision-feedback pass uses the kernel's pin tensor (App. A.7 step 5),
    # halving block time vs the XLA feedback scan (71.5 -> 36 ms/block at
    # B=32; frame/bp counters identical — docs/PERF.md).
    "concat": ConcatConfig(
        # amp_tol=1e-4: in-kernel per-codeword early stop on both AMP
        # passes (main + pinned feedback) — 69.3 -> 63.5 ms/block at B=128
        # /3 dB with identical frame/bp counters (mean 23.5 iters vs 32).
        sparc=SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_noise_in_kernel=True),
        # QC engine + row-layered schedule at half the iteration budget:
        # layered@32 matches/beats flooding@64 decode quality (scripts/
        # bp_bench.py A/B, docs/PERF.md) at half the BP compute.
        ldpc=LdpcConfig(kind="array", z=31, rows_b=4, cols_b=24,
                        engine="qc", schedule="layered", bp_iters=32),
        f_prot=0.5,
    ),
    # 4b. concat with a published standard outer code: 802.11n n=648 rate
    # 1/2 QC-LDPC (SURVEY.md §2 #16 names this family as the default
    # expectation).  648 = 72 sections of logM=9 bits -> Lp=288 protected
    # sections carry 4 LDPC codewords per frame at f_prot=0.28.
    "concat_wifi": ConcatConfig(
        sparc=SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_noise_in_kernel=True),
        ldpc=LdpcConfig(kind="qc", path="wifi_n648_r12", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28,
    ),
    # 4c. high-rate outer code: constructed rate-5/6 n=648 QC-LDPC in the
    # 802.11n structure (data/qc_n648_r56.qc) — less rate loss on the
    # protected sections (k=540/cw vs 324); same frame geometry as 4b.
    "concat_r56": ConcatConfig(
        sparc=SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_noise_in_kernel=True),
        ldpc=LdpcConfig(kind="qc", path="qc_n648_r56", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28,
    ),
    # 5. multi-host campaign over an Eb/N0 grid
    "campaign": CampaignConfig(),
}
