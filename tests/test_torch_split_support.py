"""The split AMP kernel's (K1's) tables of the row support
(sparc_ldpc_tpu_torch/ops/split_support.py), on the CPU.

The kernel keeps y and z only on the support, in its own order of the
entries, and each column-stage thread finds its entries from these tables
alone; a wrong table is a wrong decode on the card.  So every property the
kernel relies on is held here for the shipped plans (headline, concat,
fast_l4096), for small tiles of every column geometry (L = 2048 is a
cluster of two blocks) and for hand-made masks.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

import sparc_ldpc_tpu_torch as slt
from sparc_ldpc_tpu_torch.design.codebook import hadamard_plan
from sparc_ldpc_tpu_torch.ops.operators import hadamard_operator
from sparc_ldpc_tpu_torch.ops.split_support import (
    STRIP, split_geometry, split_support, split_support_from_mask)

HEADLINE = slt.SparcConfig(L=1024, M=512, R=1.0, op_kind="hadamard")
PLANS = {"headline": HEADLINE, "concat": slt.PRESETS["concat"].sparc,
         "fast_l4096": slt.PRESETS["fast_l4096"]}
SMALL = [(32, 32), (64, 128), (128, 64), (256, 32), (512, 1024),
         (1024, 64), (2048, 64)]


def _plan_support(name):
    c = PLANS[name]
    plan = hadamard_plan(c.n, c.ML, c.op_seed)
    return plan.rows.astype(np.int64), c.L, c.M


def _random_support(L, M, seed=0, density=0.05):
    rng = np.random.default_rng(seed)
    return np.flatnonzero(rng.random(L * M) < density), L, M


def _hand_made(L=1024, M=64):
    """A mask with an empty column (m = 5), a column whose support is 32
    consecutive rows, all of one thread's range (m = 9, rows 64-95), a
    full column (m = 33), and sparse random entries elsewhere."""
    rng = np.random.default_rng(7)
    mask = rng.random((L, M)) < 0.02
    mask[:, 5] = False
    mask[:, 9] = False
    mask[64:96, 9] = True
    mask[:, 33] = True
    return np.flatnonzero(mask.reshape(-1)), L, M


SUPPORTS = ([("plan", name) for name in PLANS]
            + [("small", s) for s in SMALL]
            + [("hand", None)])


def _support(kind, arg):
    if kind == "plan":
        return _plan_support(arg)
    if kind == "small":
        return _random_support(*arg)
    return _hand_made()


def _ids(p):
    kind, arg = p
    return f"{kind}-{arg[0]}x{arg[1]}" if kind == "small" else f"{kind}-{arg}"


def _words(sp):
    return sp.word.numpy().astype(np.int64) & 0xFFFFFFFF


def _popcount(x):
    return np.vectorize(lambda v: bin(int(v)).count("1"))(x)


def _kernel_order(sp, t):
    """A (L / R, M) table in the kernel's order of its ranges: (strip,
    cluster rank, column, row-range)."""
    W, R, FA = split_geometry(sp.L)
    S = sp.M // STRIP
    x = t.reshape(FA, W, S, STRIP)            # (a, w, s, c)
    return x.transpose(2, 0, 3, 1).reshape(-1)


@pytest.mark.parametrize("case", SUPPORTS, ids=_ids)
def test_counts_sum_to_the_support(case):
    rows, L, M = _support(*case)
    sp = split_support(rows, L, M)
    assert sp.ns == len(rows)
    assert int(_popcount(_words(sp)).sum()) == len(rows)
    assert int(sp.block_offset[0]) == 0
    assert int(sp.block_offset[-1]) == len(rows)


@pytest.mark.parametrize("case", SUPPORTS, ids=_ids)
def test_offsets_are_monotone_and_words_count_their_range(case):
    rows, L, M = _support(*case)
    sp = split_support(rows, L, M)
    off = _kernel_order(sp, sp.offset.numpy().astype(np.int64))
    cnt = _kernel_order(sp, _popcount(_words(sp)))
    assert (np.diff(off) >= 0).all()
    # each range's count is the gap to the next range's first entry
    assert (np.diff(np.append(off, len(rows))) == cnt).all()
    W, R, FA = split_geometry(L)
    blocks = off.reshape(-1, STRIP * W)[:, 0]
    assert np.array_equal(sp.block_offset.numpy()[:-1], blocks)


@pytest.mark.parametrize("case", SUPPORTS, ids=_ids)
def test_order_is_a_bijection_with_the_plan_rows(case):
    rows, L, M = _support(*case)
    sp = split_support(rows, L, M)
    perm, flat = sp.perm.numpy(), sp.flat.numpy()
    assert np.array_equal(np.sort(perm), np.arange(len(rows)))
    assert np.array_equal(rows[perm], flat)
    assert np.array_equal(np.sort(flat), rows)


@pytest.mark.parametrize("case", SUPPORTS, ids=_ids)
def test_each_thread_finds_its_rows_from_the_tables(case):
    """What the column stage's thread (range g, column m) does: its support
    rows are R g + k for the set bits k of its word, ascending, and their
    entries start at its offset; each block's entries are its rows and
    columns."""
    rows, L, M = _support(*case)
    sp = split_support(rows, L, M)
    W, R, FA = split_geometry(L)
    word, off, flat = _words(sp), sp.offset.numpy(), sp.flat.numpy()
    g, m = np.nonzero(word)
    for gi, mi in zip(g, m):
        ks = [k for k in range(R) if word[gi, mi] >> k & 1]
        e = off[gi, mi]
        want = [(R * gi + k) * M + mi for k in ks]
        assert flat[e:e + len(ks)].tolist() == want
    bo = sp.block_offset.numpy()
    for ib in range(FA * (M // STRIP)):
        s, a = divmod(ib, FA)
        l, mm = np.divmod(flat[bo[ib]:bo[ib + 1]], M)
        assert ((l // (L // FA)) == a).all() and ((mm // STRIP) == s).all()


@pytest.mark.parametrize("case", SUPPORTS, ids=_ids)
def test_gather_then_scatter_is_the_masked_observation(case):
    rows, L, M = _support(*case)
    sp = split_support(rows, L, M)
    mask = torch.zeros(L * M)
    mask[torch.as_tensor(rows)] = 1.0
    mask = mask.reshape(L, M)
    gen = torch.Generator().manual_seed(0)
    y_n = torch.randn((2, L, M), generator=gen)
    yc = sp.gather(y_n)
    assert yc.shape == (2, len(rows))
    back = torch.zeros((2, L * M))
    back[:, sp.flat] = yc
    assert torch.equal(back.reshape(2, L, M), torch.where(mask > 0, y_n, 0.0))


def test_hand_made_mask_takes_an_empty_and_a_full_range():
    rows, L, M = _hand_made()
    sp = split_support(rows, L, M)
    W, R, FA = split_geometry(L)
    word = _words(sp)
    assert (word[:, 5] == 0).all()               # the empty column
    g = 64 // R                                  # rows 64-95: one range
    assert word[g, 9] == 0xFFFFFFFF
    assert (np.delete(word[:, 9], g) == 0).all()
    assert (word[:, 33] == 0xFFFFFFFF).all()     # the full column
    bo = sp.block_offset.numpy()                 # its strip holds all L
    assert bo[2] - bo[1] >= L


@pytest.mark.parametrize("name", list(PLANS))
def test_shipped_plans_stay_within_one_word_a_thread(name):
    """The shipped plans hold at most 5 support rows of a thread's 32 and
    at most 630 entries a strip at L = 1024, 1588 at L = 4096, well inside
    the 4096 entries a block that the column stage stages in shared
    memory."""
    rows, L, M = _plan_support(name)
    sp = split_support(rows, L, M)
    per_thread = int(_popcount(_words(sp)).max())
    bo = sp.block_offset.numpy()
    W, R, FA = split_geometry(L)
    per_strip = int(np.diff(bo[::FA] if FA > 1 else bo).max())
    per_block = int(np.diff(bo).max())
    assert per_thread <= 5
    assert per_block <= 4096
    assert per_strip <= {1024: 630, 4096: 1588}[L]


def test_from_mask_equals_from_rows():
    rows, L, M = _plan_support("headline")
    mask = torch.zeros(L * M)
    mask[torch.as_tensor(rows)] = 1.0
    a = split_support(rows, L, M)
    b = split_support_from_mask(mask.reshape(L, M))
    for x, y in zip(a[2:], b[2:]):
        assert torch.equal(x, y)


def test_operator_builds_its_tables_once_per_device():
    op = hadamard_operator(HEADLINE)
    sp = op.split_support(HEADLINE.L, HEADLINE.M, torch.device("cpu"))
    assert op.split_support(HEADLINE.L, HEADLINE.M, "cpu") is sp
    ref = split_support_from_mask(op.mask.reshape(HEADLINE.L, HEADLINE.M))
    for x, y in zip(sp[2:], ref[2:]):
        assert torch.equal(x, y)


def test_data_parallel_takes_each_shards_tables_from_the_cache():
    """The data-parallel loop asks the operator's per-device cache for each
    shard's tables on the shard's device (no copy between devices)."""
    from sparc_ldpc_tpu_torch.parallel.amp_sharded import amp_fused_sharded
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    c = slt.SparcConfig(L=64, M=32, R=1.0, op_kind="hadamard")
    op = hadamard_operator(c)
    L, M = c.L, c.M
    asked = []

    def cache(L, M, dev):
        asked.append((L, M, torch.device(dev)))
        return op.split_support(L, M, dev)

    mask = op.mask.reshape(L, M)
    y_n = torch.randn((4, L, M), generator=torch.Generator().manual_seed(0))
    policy = ShardingPolicy(make_mesh(1, ["cpu"] * 2))
    parts = amp_fused_sharded(y_n * mask, mask, torch.ones(L), 1.0, c.n, 2,
                              policy, split_support=cache)
    beta = policy.gather([p[0] for p in parts], 0)
    assert beta.shape == (4, L, M)
    assert asked == [(L, M, torch.device("cpu"))] * 2


def test_rejects_an_unsorted_support():
    with pytest.raises(ValueError):
        split_support(np.array([5, 3]), 32, 32)
    with pytest.raises(ValueError):
        split_support(np.array([3, 32 * 32]), 32, 32)


@pytest.mark.parametrize("L", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_geometry_is_the_column_stage_dispatch(L):
    W, R, FA = split_geometry(L)
    assert W * R * FA == L and W <= R <= 32 and R % 4 == 0
    assert FA == max(1, L // 1024)


def test_dense_strip_decodes_alike_in_float32_and_float64():
    """Queue C's C2: the dense-strip mask (a whole 32-column strip on the
    support; `tools/amp_ab.py dense_strip_mask`) is not degenerate.  The
    plain version decodes it in float32 and with float64 sums with no
    flipped decision, in float32 and in bf16 operands (on an H100, K1 and
    the earlier K1 decoded it to the same bits and no flip against either,
    `amp_ab.py --dense-strip`)."""
    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused_reference
    from sparc_ldpc_tpu_torch.tools.amp_ab import (
        DENSE_STRIP_T, dense_strip_inputs)

    args, idx = dense_strip_inputs()
    wide = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    assert int(split_support_from_mask(args[1]).block_offset.diff().max()) \
        > 2048
    for prec in ("highest", "bf16"):
        b32, t32, i32 = amp_fused_reference(*args, DENSE_STRIP_T,
                                            encode_idx=idx, precision=prec,
                                            split=True)
        b64, t64, i64 = amp_fused_reference(*wide, DENSE_STRIP_T,
                                            encode_idx=idx, precision=prec,
                                            split=True)
        assert b64.dtype == torch.float64
        assert decision_flips(b64, b32) == (0, 0), prec
        assert torch.equal(i32, i64)
        np.testing.assert_allclose(t32.numpy(), t64.numpy(), rtol=1e-4)
