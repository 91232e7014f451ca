"""PyTorch/CUDA port of the SPARC and SPARC + LDPC decode paths and their
campaign CLI (the JAX package `sparc_ldpc_tpu` is the reference and is
left unchanged).

Module names mirror the reference package so each counterpart is easy to
find:

  cli.py             campaign | se | plot (python -m sparc_ldpc_tpu_torch.cli)
  parallel/campaign.py  Monte-Carlo campaign: budgets, journal resume,
                     pipelined dispatch, steady bits/s
  utils/bits.py      MSB-first bits <-> section indices
  utils/rng.py       one torch.Generator per (base, point, block)
  utils/io.py        jsonl results and the campaign journal
  utils/provenance.py  config hash, commit, backend and device of a record
  utils/profiling.py   tracing: torch.profiler traces, the program's
                     spans, counters and intervals (off when untraced)
  ops/fwht.py        Hadamard factors and plain Kronecker FWHT
  ops/fwht_kernel.py   length-N FWHT as one (f1, f2) tile: CUDA kernel
                     (csrc/amp_split.cu fwht2_run) and its plain version
  ops/operators.py   matrix-free partial-Hadamard (optional column signs),
                     subsampled DCT and dense operators
  ops/dct.py         orthonormal DCT-II / DCT-III from one complex FFT
  ops/denoiser.py    sectionwise softmax denoiser: plain, and the CUDA
                     kernel csrc/denoise.cu
  ops/amp_kernel.py  whole-trial AMP with in-kernel encode and Philox
                     noise: CUDA kernels of the split form
                     (csrc/amp_split.cu, L <= 4096), the mono form
                     (csrc/amp_mono.cu, L <= 1024) and the slab form
                     (csrc/amp_slab.cu, L <= 4096; all share
                     csrc/amp_common.cuh) and their plain PyTorch version
  ops/amp_exp.py     the split form's experiments (stage ablation, other
                     factorings of H_L, two codewords a block): CUDA
                     variants (csrc/amp_exp.cu; the stage ablation on
                     K1's own kernels, csrc/amp_k1.cuh; csrc/amp_mma.cuh)
                     and their plain version
  tools/             kernel_ablation, lstage_exp, pair_kernel_exp (the
                     experiments' entry points), amp_ab, dryrun_multichip,
                     ber_legs (the BER/FER legs against the oracle's)
  ops/bp.py          LDPC BP on padded edge tables (flooding)
  ops/bp_qc.py       QC-LDPC BP on circulant tensors (flooding, layered)
  ops/bp_qc_kernel.py  layered QC-LDPC min-sum: CUDA kernel
                     (csrc/bp_qc_layered.cu); plain version in ops/bp_qc.py
  models/amp.py      amp_decode (fused route and the scan route)
  models/sparc.py    SparcModel: build, encode, channel, decode, run_block
  models/ldpc.py     LdpcModel: encode, decode, extract_message
  models/concat.py   ConcatModel: SPARC + LDPC with decision feedback

  config.py          SparcConfig, LdpcConfig, ConcatConfig, PRESETS
  design/            power allocation, state evolution, operator plans,
                     LDPC construction (NumPy; data/*.qc base matrices)

The port imports `torch`, never `jax`, and nothing of the reference
package.  The configuration and the host-side design code define the code
itself, so config.py, design/ and data/ are the port's own copies of the
reference's, identical in classes, defaults and numerics (a config's repr
and hash are the reference's, and a campaign journal written by one
resumes in the other).  The entry points run on the first CUDA device
unless the caller passes a device (the CPU routes are for tests).
"""

import torch

from .config import (  # noqa: F401
    PRESETS, ConcatConfig, LdpcConfig, SparcConfig)

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device the main path runs on: the first CUDA device.

    Raises when no GPU is visible; the main path never falls back to the
    CPU (the CPU routes exist for tests, which pass device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the main path needs "
                           "a GPU (pass device='cpu' explicitly for the "
                           "plain CPU routes)")
    return torch.device("cuda", 0)


def check_device(device) -> torch.device:
    """Normalize `device` (None: `default_device()`); a CUDA device
    without CUDA raises."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
