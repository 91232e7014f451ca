"""The mono form's (K6's) adjoint on the row support, plain versions on
the CPU.  K6 keeps z compact, (B, ns) in the split kernel's order of the
support entries (ops/split_support.py), and builds the adjoint's
bf16(z) H_M from a row's support entries alone: (bf16(z) H_M)[l][m] = sum
over the row's entries (m', z) of (-1)^popcount(m' & m) bf16(z), then H_L.
`mono_adjoint_reference` is that computation; it must be the function
`mono_tile_reference` computes on z embedded in its (L, M) tile (which
tests/test_torch_amp.py holds to the reference's mono kernel): bit for bit
in float64 on integer inputs (every sum exact) and to 1e-6 of the output
scale in float32 (sums in another order).  The CUDA launch itself is held
to the same in tests/test_torch_cuda.py and chip_smoke.py phase 14.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu_torch.config import SparcConfig
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    mono_adjoint, mono_adjoint_reference, mono_tile_reference, pack_entries)
from sparc_ldpc_tpu_torch.ops.split_support import (
    split_support, split_support_from_mask)


def _plan_mask(L, M):
    cfg = SparcConfig(L=L, M=M, R=1.0, op_kind="hadamard", amp_iters=4,
                      amp_kernel="fused")
    return SparcModel.build(cfg, 5.0, "cpu").op.mask.reshape(L, M)


def _mask(kind, L, M):
    rng = np.random.default_rng(3)
    if kind == "plan":
        return _plan_mask(L, M)
    if kind == "empty_rows":
        mask = rng.random((L, M)) < 0.05
        mask[L // 4:L // 2] = False
        mask[L - 1] = True
    elif kind == "dense":
        mask = rng.random((L, M)) < 0.5
    else:
        mask = rng.random((L, M)) < 0.02
    return torch.tensor(mask, dtype=torch.float32)


CASES = [("plan", 256, 64), ("plan", 64, 256), ("plan", 1024, 512),
         ("random", 128, 128), ("empty_rows", 64, 128), ("dense", 32, 64),
         ("random", 32, 1024)]


def _embedded(zc, sp):
    B = zc.shape[0]
    dense = torch.zeros((B, sp.L * sp.M), dtype=zc.dtype)
    dense[:, sp.flat] = zc
    return dense.reshape(B, sp.L, sp.M)


@pytest.mark.parametrize("kind,L,M", CASES)
def test_compact_adjoint_is_the_mono_transform_of_the_embedded_z(kind, L, M):
    sp = split_support_from_mask(_mask(kind, L, M))
    rng = np.random.default_rng(L + M)
    B = 2
    ints = torch.tensor(rng.integers(-40, 41, (B, sp.ns)), dtype=torch.float64)
    got = mono_adjoint_reference(ints, sp)
    assert got.dtype == torch.float64
    assert torch.equal(got, mono_tile_reference(_embedded(ints, sp)))
    z = torch.tensor(rng.standard_normal((B, sp.ns)), dtype=torch.float32)
    ref = mono_tile_reference(_embedded(z, sp))
    err = (mono_adjoint_reference(z, sp) - ref).abs().max()
    assert float(err / ref.abs().max()) <= 1e-6


def test_mono_adjoint_on_the_cpu_is_the_plain_version():
    sp = split_support_from_mask(_mask("random", 64, 128))
    z = torch.randn((2, sp.ns), generator=torch.Generator().manual_seed(0))
    assert torch.equal(mono_adjoint(z, sp), mono_adjoint_reference(z, sp))


@pytest.mark.parametrize("kind,L,M", CASES)
def test_row_tables_list_each_rows_entries_in_column_order(kind, L, M):
    """row_offset[l] .. row_offset[l + 1] - 1 are row l's places in
    row-major order, and perm maps each entry of the kernel's order
    to its place: the flat positions read in row-major order ascend."""
    sp = split_support_from_mask(_mask(kind, L, M))
    assert sp.perm.dtype == sp.row_offset.dtype == torch.int32
    rows = sp.flat // M
    counts = torch.bincount(rows, minlength=L)
    assert torch.equal(sp.row_offset.diff().long(), counts)
    assert int(sp.row_offset[0]) == 0 and int(sp.row_offset[-1]) == sp.ns
    rowmajor = torch.empty_like(sp.flat)
    rowmajor[sp.perm.long()] = sp.flat
    assert bool((rowmajor.diff() > 0).all())


def test_packed_entries_hold_bf16_z_and_the_column():
    """K6's column stage leaves each entry as (bf16 bits << 16) | column
    at its row-major place; unpacked, the words are bf16(z) and the
    sorted support's columns."""
    L, M = 64, 256
    rows = np.flatnonzero(_plan_mask(L, M).numpy().reshape(-1))
    sp = split_support(rows, L, M)
    z = torch.randn((3, sp.ns), generator=torch.Generator().manual_seed(1))
    words = pack_entries(z, sp).to(torch.int64) & 0xFFFFFFFF
    cols = words & 0xFFFF
    vals = (words >> 16 << 16).to(torch.int32).view(torch.float32)
    assert torch.equal(cols, torch.as_tensor(rows % M).expand(3, -1))
    want = z.to(torch.bfloat16).float()
    assert torch.equal(vals[:, sp.perm.long()], want)
