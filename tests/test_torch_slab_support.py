"""The slab AMP kernel's (K7's) use of the row-support layout
(sparc_ldpc_tpu_torch/ops/split_support.py, csrc/amp_slab.cu), on the CPU.

K7 keeps y and z only on the row support, in K1's order of the entries.
Its column launch (C1) finds each element's entry from K1's tables in the
layout of its tensor-core products and writes one |z|^2 partial per
(codeword, slab of f_b rows, 32-column strip); its adjoint launch (R2C2)
builds each strip's H_M from each row's bf16 entries.  Held here for the
shipped plans, small tiles of every column geometry (clusters of two and
four blocks at L = 2048, 4096) and a hand-made mask: the lookup by
position, the slab boundaries of the column blocks, the partials in C1's
layout against a dense computation (and their sum in R3's order against
`_slab_sq_sum`, the plain version's), and the sparse build against the
dense transform.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

import sparc_ldpc_tpu_torch as slt
from sparc_ldpc_tpu_torch.design.codebook import hadamard_plan
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    _parity_signs, _slab_sq_sum, pack_entries, slab_adjoint,
    slab_adjoint_reference, slab_geometry)
from sparc_ldpc_tpu_torch.ops.fwht import fwht_kron, round_bf16
from sparc_ldpc_tpu_torch.ops.split_support import (
    BLOCK_ROWS, STRIP, split_geometry, split_support)

PLANS = {"headline": slt.SparcConfig(L=1024, M=512, R=1.0,
                                     op_kind="hadamard"),
         "concat": slt.PRESETS["concat"].sparc,
         "fast_l4096": slt.PRESETS["fast_l4096"]}
SMALL = [(32, 32), (64, 128), (128, 64), (256, 32), (512, 256),
         (1024, 64), (2048, 64), (4096, 32)]


def _rows(kind, arg):
    if kind == "plan":
        c = PLANS[arg]
        plan = hadamard_plan(c.n, c.ML, c.op_seed)
        return plan.rows.astype(np.int64), c.L, c.M
    if kind == "small":
        L, M = arg
        rng = np.random.default_rng(L + M)
        return np.flatnonzero(rng.random(L * M) < 0.05), L, M
    # an empty column, a column on one thread range only, a full column,
    # a full row
    L, M = 1024, 64
    rng = np.random.default_rng(7)
    mask = rng.random((L, M)) < 0.02
    mask[:, 5] = False
    mask[:, 9] = False
    mask[64:96, 9] = True
    mask[:, 33] = True
    mask[200] = True
    return np.flatnonzero(mask.reshape(-1)), L, M


def slab_sq_partials(zc, sp):
    """The |z|^2 partials of the compact z (B, ns) as K7's C1 writes them,
    one per (codeword, slab of f_b rows, 32-column strip): (B, f_a,
    M / 32), each entry added to the partial of its row's slab and its
    column's strip."""
    L, M = sp.L, sp.M
    f_a, f_b = slab_geometry(L, M)[:2]
    part = (sp.flat // M // f_b) * (M // STRIP) + (sp.flat % M) // STRIP
    out = torch.zeros((zc.shape[0], f_a * (M // STRIP)), dtype=zc.dtype)
    out.index_add_(1, part, zc * zc)
    return out.reshape(zc.shape[0], f_a, M // STRIP)


def slab_sq_total(partials):
    """K7's R3 sum of slab_sq_partials: each slab's strips, then the slabs
    in slab order."""
    parts = partials.sum(-1)
    total = parts[:, 0]
    for a in range(1, parts.shape[1]):
        total = total + parts[:, a]
    return total


CASES = ([("plan", n) for n in PLANS] + [("small", s) for s in SMALL]
         + [("hand", None)])


def _ids(case):
    kind, arg = case
    if kind == "small":
        return f"small-{arg[0]}x{arg[1]}"
    return f"{kind}-{arg}"


def _case(case, B=3, dtype=torch.float64, seed=0):
    rows, L, M = _rows(*case)
    sp = split_support(rows, L, M)
    rng = np.random.default_rng(seed)
    zc = torch.tensor(rng.standard_normal((B, sp.ns)), dtype=dtype)
    dense = torch.zeros((B, L * M), dtype=dtype)
    dense[:, sp.flat] = zc
    return sp, zc, dense.reshape(B, L, M)


@pytest.mark.parametrize("L", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_c1_geometry_mirrors_the_tables(L):
    """C1's row range of the tables (SlabGeo::RR) is split_geometry's R,
    and its column blocks (min(L, 1024) rows, a cluster of L / 1024 above)
    are K1's, each holding whole slabs of f_b rows."""
    W, R, FA = split_geometry(L)
    rr = 8 if L <= 64 else 16 if L <= 256 else 32
    assert rr == R
    f_a, f_b = slab_geometry(L, 64)[:2]
    rows_a_block = min(L, BLOCK_ROWS)
    assert FA == L // rows_a_block and rows_a_block % f_b == 0
    assert f_a * f_b == L


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_element_finds_its_entry_from_the_tables(case):
    """C1's lookup by position: bit l % R of word[(l // R) M + m] says
    whether (l, m) is on the support, and offset + the set bits below it
    give its entry, whose position is (l, m)."""
    rows, L, M = _rows(*case)
    sp = split_support(rows, L, M)
    R = split_geometry(L)[1]
    word = sp.word.numpy().astype(np.int64) & 0xFFFFFFFF
    offset = sp.offset.numpy().astype(np.int64)
    l, m = np.divmod(np.arange(L * M), M)
    w = word[l // R, m]
    k = l % R
    on = (w >> k) & 1
    below = w & ((np.int64(1) << k) - 1)
    count = np.vectorize(lambda v: bin(int(v)).count("1"))(below)
    mask = np.zeros(L * M, dtype=np.int64)
    mask[rows] = 1
    np.testing.assert_array_equal(on, mask)
    e = (offset[l // R, m] + count)[on == 1]
    np.testing.assert_array_equal(sp.flat.numpy()[e],
                                  np.flatnonzero(mask))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_column_blocks_hold_their_rows_entries(case):
    """K1's block (strip s, cluster rank c), whose entries C1 stages, holds
    exactly the support entries of strip s in rows [c LB, (c + 1) LB)."""
    rows, L, M = _rows(*case)
    sp = split_support(rows, L, M)
    FA = split_geometry(L)[2]
    LB = L // FA
    flat = sp.flat.numpy()
    bo = sp.block_offset.numpy()
    for s in range(M // STRIP):
        for c in range(FA):
            e = flat[bo[s * FA + c]:bo[s * FA + c + 1]]
            l, m = np.divmod(e, M)
            assert ((l // LB == c) & (m // STRIP == s)).all()
            want = ((rows // M) // LB == c) & ((rows % M) // STRIP == s)
            assert len(e) == int(want.sum())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partials_match_a_dense_computation(case):
    """The compact z's |z|^2 partials, one per (slab, strip), equal the
    dense tile's sums over the same rows and columns."""
    sp, zc, dense = _case(case)
    L, M = sp.L, sp.M
    f_a, f_b = slab_geometry(L, M)[:2]
    want = (dense * dense).reshape(dense.shape[0], f_a, f_b, M // STRIP,
                                   STRIP).sum((2, 4))
    torch.testing.assert_close(slab_sq_partials(zc, sp), want, rtol=1e-12,
                               atol=0.0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partials_sum_to_the_plain_versions_slab_sum(case, dtype, rtol):
    """Each slab's strips, then the slabs in slab order: the plain
    version's `_slab_sq_sum` of the dense z."""
    sp, zc, dense = _case(case, dtype=dtype)
    got = slab_sq_total(slab_sq_partials(zc, sp))
    torch.testing.assert_close(got, _slab_sq_sum(dense, sp.L // slab_geometry(
        sp.L, sp.M)[0]), rtol=rtol, atol=0.0)


def _sparse_build(zc, sp):
    """R2C2's arithmetic in plain PyTorch: each row's H_M from its bf16
    entries (a +-1 term each, float32 sums), rounded to bf16, then H_L."""
    L, M = sp.L, sp.M
    rows, cols = sp.flat // M, sp.flat % M
    terms = round_bf16(zc)[:, :, None] * _parity_signs(cols, M, zc.dtype)
    u = torch.zeros((zc.shape[0], L, M), dtype=zc.dtype)
    u.index_add_(1, rows, terms)
    return fwht_kron(round_bf16(u), "highest", -2)


@pytest.mark.parametrize("case", [("small", (64, 128)),
                                  ("small", (256, 32)), ("hand", None)],
                         ids=_ids)
def test_sparse_adjoint_is_the_dense_transform_on_integers(case):
    """On integer z every sum is exact, so R2C2's sparse build of H_M is
    the dense transform's bit for bit; on the CPU `slab_adjoint` is the
    plain version."""
    sp, _, _ = _case(case)
    rng = np.random.default_rng(3)
    zc = torch.tensor(rng.integers(-8, 9, (2, sp.ns)), dtype=torch.float32)
    ref = slab_adjoint_reference(zc, sp)
    assert torch.equal(_sparse_build(zc, sp), ref)
    assert torch.equal(slab_adjoint(zc, sp), ref)


@pytest.mark.parametrize("case", [("small", (64, 128)), ("hand", None)],
                         ids=_ids)
def test_packed_entries_carry_bf16_z_and_column_in_row_major_order(case):
    """C1 packs each entry as (bf16(z) << 16) | m at its row-major place,
    which R2C2 reads row by row."""
    sp, zc, _ = _case(case, dtype=torch.float32)
    packed = pack_entries(zc, sp).numpy().astype(np.int64) & 0xFFFFFFFF
    order = np.argsort(sp.flat.numpy())
    np.testing.assert_array_equal(packed & 0xFFFF,
                                  np.broadcast_to(sp.flat.numpy()[order]
                                                  % sp.M, packed.shape))
    z = torch.tensor((packed >> 16).astype(np.int16)).view(torch.bfloat16)
    assert torch.equal(z.float(), round_bf16(zc)[:, order])
    row_offset = sp.row_offset.numpy()
    rows = sp.flat.numpy()[order] // sp.M
    np.testing.assert_array_equal(np.searchsorted(rows, np.arange(sp.L + 1)),
                                  row_offset)
