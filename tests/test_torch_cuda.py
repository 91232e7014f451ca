"""The CUDA kernels (sparc_ldpc_tpu_torch/csrc/amp_split.cu, with its
in-kernel noise, L up to 4096 and the fwht2 entry, csrc/amp_mono.cu,
csrc/bp_qc_layered.cu and csrc/denoise.cu) against their plain PyTorch
versions, on an NVIDIA GPU.

Every test here is marked `cuda` and skips where no GPU is visible.  The
file imports no JAX, so it also runs where the JAX reference is not
installed; there the suite's conftest (which imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: in float32 the kernel and the plain version differ only in
summation order (tau2 to rtol 1e-4, beta to 1e-3, decisions
margin-aware); with bf16 operand rounding they agree in distribution
(tau2 to rtol 2e-2, no decisive flips at these well-decoding points).
With the early stop, iteration counts within 4 (the reference's rule) and
the traces compared up to the first stop.  The layered BP kernel is
bitwise equal to its plain version.  The in-kernel noise draws the same
uniforms as its plain version bit for bit and normals within 1e-5 (log,
sin and cos differ in their last bits); the FWHT within 1e-5 of the
output scale; the denoiser to rtol 1e-5 (beta: atol 1e-6 max sq, post:
atol 1e-7).  The mono form (amp_mono.cu) rounds where its plain version
does, once per transform before H_M, so its transform alone, and its
adjoint built from the compact z, agree to 1e-5 of the output scale and
its decode to the bf16 tolerances above; it keeps y and z on the split
form's support tables, held on hand-made masks, with frozen codewords and
repeats bit for bit.  K3 (`fwht_tile`) in bf16 rounds where its plain
version does: integer inputs bit for bit, normals within one bf16 ulp of
the largest H_M value, on each of its designs.
The slab form (amp_slab.cu) also rounds where its plain version does,
before H_M and before H_L; its transform is bit-equal on integer inputs
(every sum exact) and within one bf16 ulp of the largest H_M value on
normals (the two sum in other orders, so a rounding of the H_M stage may
fall to the other neighbour), its decode held to the bf16 tolerances.
Since its redesign it keeps y and z on the split form's support tables
too (three launches an iteration: C1 on the support, R2C2 the adjoint
from the compact z, R3): held on hand-made masks (empty columns and rows,
dense blocks past what its launches stage, an L = 4096 cluster), with
frozen codewords and repeats bit for bit; its adjoint alone bit-equal on
integer z.  K5 (`fwht2`) within 1e-5 of the scale, integer inputs bit for
bit (every sum exact), up to N = 2^20 and at batches of 1 and 37.
The split form keeps y and z on the row support only, found through its
support tables (ops/split_support.py): hand-made masks (an empty column,
a full thread range, a full column, a strip with more entries than it
stages, also inside an L = 4096 cluster) hold to the same rules; its
column stage's resident walkers each walk several (codeword, strip) items
when the items outnumber them, frozen codewords skipped, and repeat bit
for bit; a call without the tables builds them from the mask and gives
the same bits.
The split kernel's experiments (amp_exp.cu: S2's stage ablation, S3's
factorings of H_L, S1's two codewords a block) at the scripts' shape:
the decoding variants (full, S3, pair) in bf16 over T = 32 (at most 1 %
flipped sections, tau2 to rtol 2e-2), full and the pair also in float32
(no decisive flip, tau2 to rtol 1e-4); the ablated variants, whose
decodes are garbage, over T = 2 in float32 and in bf16 (beta within
1e-2 of the output scale, NaN where the plain version has NaN; in bf16
against the plain version rounded where the kernels round,
order="kernel": the scripts round the adjoint at other places, which a
garbage decode amplifies; the pair always, as K1 computes full).  S2's
full and S1's pair are K1's fixed-T call with y given, bit for bit (the
same kernels: S2 is K1's at compile-time variants, the pair K1's column
stage and K1's row stage at its paired variant), and S2 and S3 give the
same bits without K1's support tables.
The slab kernel's stage ablation (amp_slab_exp.cu, S4) at the script's
shape: K7's own kernels at compile-time variants, each held to the plain
version of its form (order="kernel", K7's rounding points): the decoding
variants over T = 32 (at most 1 % flipped sections, tau2 to rtol 2e-2),
the ablated ones over T = 2 (beta within 1e-2 of the output scale, no NaN
but no_consume's from beta' = 0, which is NaN throughout on both sides:
its first tau2 is 0).  no_consume is held from a decoded state instead
(the state one plain full iteration leaves); a run resumed from its own
kept state gives the bits of an unbroken one; full is K7's fixed-T call
(amp_fused, slab form) bit for bit.
The column-signed Hadamard operator (on fwht_kron, and on K5 with
use_pallas) and the DCT operator (cuFFT) at full width against the same
operators on the CPU, within 1e-4 of the output scale, adjoint within
1e-6 of |Ax| |z|; one block of the BER leg tool's concat_small legs (the
float32 control with TF32 off and no hand-written kernel, the torch leg
on K1 and K2).
"""

import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu_torch.config import ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu_torch.design.ldpc_codes import build_code, qc_structure
from sparc_ldpc_tpu_torch.models.amp import decision_flips
from sparc_ldpc_tpu_torch.models.concat import ConcatModel
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_exp import (
    ABLATED, MODES, S2_MODES, S3_MODES, amp_exp, amp_exp_reference,
    mode_f_b)
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, channel_noise, channel_noise_reference,
    fwht_tile, fwht_tile_reference, mono_adjoint, mono_tile_reference,
    noise_uniforms, noise_uniforms_reference, slab_adjoint,
    slab_adjoint_reference, slab_tile)
from sparc_ldpc_tpu_torch.ops.amp_slab_exp import (
    ABLATED as SLAB_ABLATED, MODES as SLAB_MODES, SlabState, amp_slab_exp,
    amp_slab_exp_reference, compact_mask, parse_mode)
from sparc_ldpc_tpu_torch.ops.denoiser import denoise, denoise_kernel
from sparc_ldpc_tpu_torch.ops.fwht import fwht_kron, round_bf16
from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2, fwht2_reference
from sparc_ldpc_tpu_torch.ops.split_support import split_support_from_mask
from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
from sparc_ldpc_tpu_torch.tools.amp_ab import dense_strip_mask
from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs the same "
                    "comparisons at full width on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _config(L, M):
    return SparcConfig(L=L, M=M, R=1.0, op_kind="hadamard", amp_iters=8,
                       amp_tol=0.0, transform_precision="bf16",
                       amp_kernel="fused_split")


def _inputs(L, M, B, device, ebno_db=5.0, seed=0):
    """Embedded noise y_n, mask, sq_npl and true indices on `device`."""
    model = SparcModel.build(_config(L, M), ebno_db, "cpu")
    c = model.cfg
    rng = np.random.default_rng(seed)
    bits = torch.tensor(rng.integers(0, 2, (B, c.k_bits)), dtype=torch.int32)
    noise = torch.tensor(rng.standard_normal((B, c.n)), dtype=torch.float32)
    y_n = model.op.embed_y(noise * math.sqrt(model.sigma2)).reshape(B, L, M)
    return (model, y_n.to(device), model.op.mask.reshape(L, M).to(device),
            model.sq_npl.to(device), bits_to_indices(bits, c.logM).to(device))


@pytest.mark.parametrize("L,M", [(64, 128), (256, 512), (1024, 512),
                                 (2048, 64), (4096, 512)])
def test_cuda_fwht_tile_matches_plain(cuda_device, L, M):
    x = torch.randn((2, L, M), device=cuda_device)
    launches = fwht_tile.launches
    for prec, tol in (("highest", 1e-5), ("bf16", 1e-4)):
        ref = fwht_tile_reference(x, prec)
        err = (fwht_tile(x, prec) - ref).abs().max() / ref.abs().max()
        assert float(err) <= tol, (prec, float(err))
    assert fwht_tile.launches == launches + 2


@pytest.mark.parametrize("L,M", [(64, 128), (256, 256), (1024, 512)])
def test_cuda_amp_fused_matches_plain(cuda_device, L, M):
    model, y_n, mask, sq, idx = _inputs(L, M, 4, cuda_device)
    c = model.cfg
    args = (y_n, mask, sq, c.P, c.n, c.amp_iters)
    launches = amp_fused.launches
    bk, tk, ik = amp_fused(*args, encode_idx=idx, precision="highest",
                           split=True)
    assert amp_fused.launches == launches + 1
    bp, tp, ip = amp_fused_reference(*args, encode_idx=idx,
                                     precision="highest", split=True)
    assert torch.equal(ik.cpu(), ip.cpu())
    flips, decisive = decision_flips(bp, bk)
    assert decisive == 0 and flips <= 0.01 * idx.numel()
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=1e-4)
    assert float((bk - bp).abs().max()) <= 1e-3
    bk, tk, _ = amp_fused(*args, encode_idx=idx, split=True)
    bp, tp, _ = amp_fused_reference(*args, encode_idx=idx, split=True)
    assert decision_flips(bp, bk)[1] == 0
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=2e-2)
    # without encode_idx, y_n is the whole observation: only masked
    bk, tk, _ = amp_fused(*args, precision="highest", split=True)
    bp, tp, _ = amp_fused_reference(*args, precision="highest", split=True)
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=1e-4)
    assert float((bk - bp).abs().max()) <= 1e-3


@pytest.mark.parametrize("L", [2048, 4096])
def test_cuda_amp_split_large_l_matches_plain(cuda_device, L):
    """K1 (f): the split form at L = 2048 and 4096 (a cluster of L / 1024
    column-stage blocks per strip), fixed T and with the early stop, in
    float32 and with bf16 rounding; "fused" routes there by itself."""
    model, y_n, mask, sq, idx = _inputs(L, 64, 2, cuda_device, ebno_db=6.0)
    c = model.cfg
    args = (y_n, mask, sq, c.P, c.n, 8)
    launches = (amp_fused.launches, amp_fused.mono_launches)
    for kw, rtol in ((dict(precision="highest"), 1e-4),
                     (dict(precision="highest", tol=1e-4), 1e-4),
                     (dict(), 2e-2)):
        bk, tk, ik = amp_fused(*args, encode_idx=idx, **kw)
        bp, tp, ip = amp_fused_reference(*args, encode_idx=idx, **kw)
        ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
        assert np.abs(ik - ip).max() <= 4, (kw, ik, ip)
        t_min = int(min(ik.min(), ip.min()))
        np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                                   tp[:t_min].cpu().numpy(), rtol=rtol)
        assert decision_flips(bp, bk)[1] == 0
        if rtol == 1e-4 and (ik == ip).all():
            assert float((bk - bp).abs().max()) <= 1e-3
    assert amp_fused.launches == launches[0] + 3
    assert amp_fused.mono_launches == launches[1]


def _support_inputs(mask, B, device, sigma=0.1, seed=0):
    """Noise on mask's support, flat power, true indices: (args without T,
    idx) for amp_fused on a mask of any support."""
    L, M = mask.shape
    n = int(mask.sum())
    rng = np.random.default_rng(seed)
    y_n = torch.tensor(rng.standard_normal((B, L, M)) * sigma,
                       dtype=torch.float32) * mask
    idx = torch.tensor(rng.integers(0, M, (B, L)), dtype=torch.int32)
    sq = torch.full((L,), math.sqrt(n / L))
    return ((y_n.to(device), mask.to(device), sq.to(device), 1.0, n),
            idx.to(device))


# support entries a column-stage block stages in shared memory
# (entry_cap in csrc/amp_split.cu); a block with more reads them in place
STAGED_ENTRIES = 2048


def _hand_made_mask(kind, M=64):
    """"hand": sparse random support with an empty column (5), a column
    whose support is all 32 rows of one column-stage thread (9, rows
    64-95) and a full column (33); "dense": a random support of density
    0.1, about 3300 entries a column-stage block, more than it stages in
    shared memory; "dense_l4096" the same at L = 4096, where each block
    of a cluster holds 1024 of a strip's rows; "dense_strip" the hand-made
    mask with the whole strip of columns 32-63 on the support
    (`dense_strip_mask`, 32 768 entries in that strip's block).  The
    dense strip decodes with no flip against the plain version in float32
    and float64 and the earlier K1, and the earlier K1's bits
    (tools/amp_ab.py --dense-strip on an H100); "empty_rows" (the mono
    form's case) a sparse random support with rows 100-163 empty and row
    200 full."""
    if kind == "dense_strip":
        return dense_strip_mask(M=M)
    L = 4096 if kind == "dense_l4096" else 1024
    rng = np.random.default_rng(7)
    if kind == "hand":
        mask = rng.random((L, M)) < 0.02
        mask[:, 5] = False
        mask[:, 9] = False
        mask[64:96, 9] = True
        mask[:, 33] = True
    elif kind == "empty_rows":
        mask = rng.random((L, M)) < 0.02
        mask[100:164] = False
        mask[200] = True
    else:
        mask = rng.random((L, M)) < 0.1
    return torch.tensor(mask, dtype=torch.float32)


def _hold_split(out_k, out_p, idx, f32: bool):
    """K1's rules against its plain version (module docstring)."""
    (bk, tk, ik), (bp, tp, ip) = out_k, out_p
    ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
    assert np.abs(ik - ip).max() <= (4 if f32 else 32), (ik, ip)
    t_min = int(min(ik.min(), ip.min()))
    np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                               tp[:t_min].cpu().numpy(),
                               rtol=1e-4 if f32 else 2e-2)
    flips, decisive = decision_flips(bp, bk)
    assert decisive == 0 and flips <= 0.01 * idx.numel()
    if f32 and (ik == ip).all():
        assert float((bk - bp).abs().max()) <= 1e-3


@pytest.mark.parametrize("kind", ["hand", "dense", "dense_l4096",
                                  "dense_strip"])
def test_cuda_amp_split_hand_made_masks_match_plain(cuda_device, kind):
    """The support layout's corner cases: an empty column, a thread whose
    32 rows are all on the support, a full column, and a strip with more
    entries than the column stage stages in shared memory (it reads them
    from device memory), alone and in a cluster, and one strip filled
    densely."""
    mask = _hand_made_mask(kind)
    blocks = split_support_from_mask(mask).block_offset.diff()
    if kind in ("dense", "dense_l4096"):
        assert int(blocks.min()) > STAGED_ENTRIES
    elif kind == "dense_strip":
        assert int(blocks.max()) > STAGED_ENTRIES
    args, idx = _support_inputs(mask, 3, cuda_device)
    for prec in ("highest", "bf16"):
        kw = dict(encode_idx=idx, precision=prec, split=True)
        _hold_split(amp_fused(*args, 8, **kw),
                    amp_fused_reference(*args, 8, **kw), idx,
                    prec == "highest")


@pytest.mark.parametrize("L,M", [(32, 32), (128, 1024), (512, 64)])
def test_cuda_amp_split_row_shapes_match_plain(cuda_device, L, M):
    """The row stage's warp layouts: 4 rows a warp (M = 32), 2 (M = 64),
    and 32 values a lane (M = 1024)."""
    model, y_n, mask, sq, idx = _inputs(L, M, 3, cuda_device, ebno_db=6.0)
    c = model.cfg
    args = (y_n, mask, sq, c.P, c.n, 6)
    for prec in ("highest", "bf16"):
        kw = dict(encode_idx=idx, precision=prec, split=True)
        _hold_split(amp_fused(*args, **kw), amp_fused_reference(*args, **kw),
                    idx, prec == "highest")


@pytest.mark.parametrize("L,B", [(1024, 192), (4096, 64)])
def test_cuda_amp_split_walker_skips_frozen_codewords(cuda_device, L, B):
    """With the early stop codewords freeze at different iterations; the
    column stage's walkers skip their items.  The (codeword, strip) items
    outnumber the walkers (one resident block an SM, or one cluster of
    L / 1024 blocks), so each walker walks several of them; the result
    keeps the plain version's iteration counts and repeats bit for bit."""
    M = 64
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert B * (M // 32) > sms // max(1, L // 1024)
    model, y_n, mask, sq, idx = _inputs(L, M, B, cuda_device, ebno_db=6.0)
    c = model.cfg
    # half the codewords at a quarter of the noise power settle sooner
    y_n[:B // 2] *= 0.5
    args = (y_n, mask, sq, c.P, c.n, 16)
    kw = dict(encode_idx=idx, precision="highest", split=True, tol=1e-3)
    out = amp_fused(*args, **kw)
    again = amp_fused(*args, **kw)
    ik = out[2].cpu().numpy()
    assert ik.min() < ik.max(), ik   # frozen at different iterations
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    _hold_split(out, amp_fused_reference(*args, **kw), idx, True)


@pytest.mark.parametrize("L,M", [(1024, 512), (4096, 512)])
def test_cuda_amp_split_repeats_bit_for_bit(cuda_device, L, M):
    """Two runs of the same inputs, and a run without the tables (built from
    the mask) against one with the operator's, equal bit for bit."""
    model, y_n, mask, sq, idx = _inputs(L, M, 2, cuda_device, ebno_db=6.0)
    c = model.cfg
    args = (y_n, mask, sq, c.P, c.n, 6)
    seeds = torch.tensor([[1, 2], [-3, 4]], dtype=torch.int32,
                         device=cuda_device)
    sup = model.op.split_support(L, M, cuda_device)
    for kw in (dict(encode_idx=idx), dict(encode_idx=idx, tol=1e-3),
               dict(encode_idx=idx, noise_seed=seeds, noise_sigma=0.5)):
        a = args if "noise_seed" not in kw else (None,) + args[1:]
        first = amp_fused(*a, split=True, support=sup, **kw)
        again = amp_fused(*a, split=True, support=sup, **kw)
        built = amp_fused(*a, split=True, **kw)
        for x, y, z in zip(first, again, built):
            assert torch.equal(x, y) and torch.equal(x, z), kw.keys()


def test_cuda_amp_split_rejects_tables_of_another_tile(cuda_device):
    model, y_n, mask, sq, idx = _inputs(64, 128, 2, cuda_device)
    c = model.cfg
    other = SparcModel.build(_config(128, 64), 5.0, "cpu").op.split_support(
        128, 64, cuda_device)
    with pytest.raises(ValueError, match="tile"):
        amp_fused(y_n, mask, sq, c.P, c.n, 4, encode_idx=idx, split=True,
                  support=other)
    cpu = model.op.split_support(64, 128, "cpu")
    with pytest.raises(ValueError, match="support"):
        amp_fused(y_n, mask, sq, c.P, c.n, 4, encode_idx=idx, split=True,
                  support=cpu)


@pytest.mark.parametrize("L,M", [(64, 128), (256, 256), (1024, 512)])
def test_cuda_amp_mono_matches_plain(cuda_device, L, M):
    """K6 (the mono form, "fused" at L <= 1024) against its plain version:
    fixed T, early stop, pinning and an SE schedule.  The mono form
    computes in bf16 only, so with tol the iteration counts are held to
    the bf16 rule of chip_smoke.py's phase 6 (their means within 2: one
    codeword stopped 6 iterations apart on an H100); without tol each
    codeword runs all T on both sides."""
    model, y_n, mask, sq, idx = _inputs(L, M, 4, cuda_device, ebno_db=6.0)
    c = model.cfg
    T = 16
    args = (y_n, mask, sq, c.P, c.n, T)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    pin = torch.randint(0, M, (4, L), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    keep = torch.rand((4, L), generator=gen, device=cuda_device) < 0.4
    pin = torch.where(keep, pin, -1).to(torch.int32)
    sched = torch.linspace(0.5, 0.05, T, device=cuda_device)
    launches = (amp_fused.launches, amp_fused.mono_launches)
    opts = (dict(), dict(tol=1e-4), dict(tol=1e-4, pin_idx=pin),
            dict(tau2_schedule=sched), dict(encode_idx=None))
    for opt in opts:
        kw = dict(dict(encode_idx=idx), **opt)
        bk, tk, ik = amp_fused(*args, **kw)
        bp, tp, ip = amp_fused_reference(*args, **kw)
        assert bool(torch.isfinite(bk).all() & torch.isfinite(tk).all())
        ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
        if "tol" in opt:    # a bf16 near-tie may set one codeword's stop
            assert abs(float(np.mean(ik - ip))) <= 2, (opt.keys(), ik, ip)
        else:
            np.testing.assert_array_equal(ik, ip)
        t_min = int(min(ik.min(), ip.min()))
        np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                                   tp[:t_min].cpu().numpy(), rtol=2e-2)
        assert decision_flips(bp, bk)[1] == 0
        if "pin_idx" in opt:
            rows = pin >= 0
            assert torch.equal(bk[rows], bp[rows])
            assert torch.equal(bk[rows].argmax(-1), pin[rows].long())
        if "tau2_schedule" in opt:
            assert torch.equal(tk, sched[:, None].expand(T, 4))
            assert (ik == T).all()
        if "tol" in opt:
            assert ik.max() < T, "the point must stop early"
    assert amp_fused.mono_launches == launches[1] + len(opts)
    assert amp_fused.launches == launches[0]


def test_cuda_amp_mono_rejects_what_it_cannot_take(cuda_device):
    model, y_n, mask, sq, idx = _inputs(64, 128, 2, cuda_device)
    c = model.cfg
    args = (y_n, mask, sq, c.P, c.n, 4)
    with pytest.raises(ValueError):         # H_M runs on bf16 tensor cores
        amp_fused(*args, encode_idx=idx, precision="highest")
    with pytest.raises(ValueError):         # the noise is the split form's
        amp_fused(None, *args[1:], encode_idx=idx, form="mono",
                  noise_seed=_seeds(2, cuda_device), noise_sigma=0.5)
    with pytest.raises(ValueError):         # so is it on the slab form
        amp_fused(None, *args[1:], encode_idx=idx, form="slab",
                  noise_seed=_seeds(2, cuda_device), noise_sigma=0.5)
    with pytest.raises(ValueError):         # H_{m_b}, H_{f_b} on bf16 cores
        amp_fused(*args, encode_idx=idx, form="slab", precision="highest")


@pytest.mark.parametrize("L,M,density", [(64, 128, 0.05), (256, 512, 0.02),
                                         (1024, 512, 0.018),
                                         (1024, 64, 0.5), (32, 1024, 0.1)])
def test_cuda_mono_adjoint_matches_plain(cuda_device, L, M, density):
    """K6's adjoint launch alone (bf16(z) H_M built from the compact z,
    then H_L): against `mono_tile_reference` of z embedded in its tile, on
    integer z bit for bit (every sum exact) and on normals to 1e-5 of the
    output scale; (1024, 64, 0.5) has more entries than the launch stages
    in shared memory."""
    rng = np.random.default_rng(1)
    mask = torch.tensor(rng.random((L, M)) < density, dtype=torch.float32)
    sp = split_support_from_mask(mask).to(cuda_device)
    B = 3
    for z in (rng.integers(-8, 9, (B, sp.ns)), rng.standard_normal((B, sp.ns))):
        zc = torch.tensor(z, dtype=torch.float32, device=cuda_device)
        dense = torch.zeros((B, L * M), device=cuda_device)
        dense[:, sp.flat] = zc
        ref = mono_tile_reference(dense.reshape(B, L, M))
        got = mono_adjoint(zc, sp)
        if z.dtype.kind == "i":
            assert torch.equal(got, ref)
        else:
            err = (got - ref).abs().max() / ref.abs().max()
            assert float(err) <= 1e-5, float(err)


def _hold_mono(out_k, out_p, idx, tol: bool):
    """K6's rules against its plain version (bf16: module docstring):
    iteration counts equal at fixed T, their means within 2 with tol."""
    (bk, tk, ik), (bp, tp, ip) = out_k, out_p
    assert bool(torch.isfinite(bk).all() & torch.isfinite(tk).all())
    ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
    if tol:
        assert abs(float(np.mean(ik - ip))) <= 2, (ik, ip)
    else:
        np.testing.assert_array_equal(ik, ip)
    t_min = int(min(ik.min(), ip.min()))
    np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                               tp[:t_min].cpu().numpy(), rtol=2e-2)
    flips, decisive = decision_flips(bp, bk)
    assert decisive == 0 and flips <= 0.01 * idx.numel()


@pytest.mark.parametrize("kind", ["hand", "empty_rows", "dense",
                                  "dense_strip"])
def test_cuda_amp_mono_hand_made_masks_match_plain(cuda_device, kind):
    """K6 keeps y and z on the row support in K1's layout: an empty column,
    empty rows, a full row, a random support of density 0.1 (more entries
    a column block than its column launch stages) and a dense strip (more
    entries a codeword than its adjoint launch stages); against its plain
    version and a second identical run bit for bit."""
    mask = _hand_made_mask(kind)
    args, idx = _support_inputs(mask, 3, cuda_device)
    launches = amp_fused.mono_launches
    for kw in (dict(), dict(tol=1e-4)):
        kw = dict(encode_idx=idx, form="mono", **kw)
        out = amp_fused(*args, 8, **kw)
        again = amp_fused(*args, 8, **kw)
        for a, b in zip(out, again):
            assert torch.equal(a, b)
        _hold_mono(out, amp_fused_reference(*args, 8, **kw), idx,
                   "tol" in kw)
    assert amp_fused.mono_launches == launches + 4


def test_cuda_amp_mono_walker_skips_frozen_codewords(cuda_device):
    """With the early stop codewords freeze at different iterations; K6's
    column launches' walkers skip their items ((codeword, strip) items
    outnumber the walkers); the result keeps the plain version's rules and
    repeats bit for bit."""
    L, M, B = 1024, 64, 192
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert B * (M // 32) > sms
    model, y_n, mask, sq, idx = _inputs(L, M, B, cuda_device, ebno_db=6.0)
    c = model.cfg
    y_n[:B // 2] *= 0.5
    args = (y_n, mask, sq, c.P, c.n, 16)
    kw = dict(encode_idx=idx, form="mono", tol=1e-3)
    out = amp_fused(*args, **kw)
    again = amp_fused(*args, **kw)
    ik = out[2].cpu().numpy()
    assert ik.min() < ik.max(), ik
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    _hold_mono(out, amp_fused_reference(*args, **kw), idx, True)


@pytest.mark.parametrize("L,M", [(32, 32), (64, 256), (256, 512),
                                 (1024, 512), (2048, 64), (4096, 128)])
def test_cuda_slab_tile_matches_plain(cuda_device, L, M):
    """K7's transform alone, H_L bf16(H_M bf16(x)), against its plain
    version: integer inputs bit for bit, normals within one bf16 ulp of
    the largest H_M value."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ints = torch.randint(-8, 9, (2, L, M), generator=gen,
                         device=cuda_device).float()
    assert torch.equal(slab_tile(ints), fwht_tile_reference(ints, "bf16"))
    x = torch.randn((2, L, M), generator=gen, device=cuda_device)
    ref = fwht_tile_reference(x, "bf16")
    top = float(fwht_kron(round_bf16(x), "highest", -1).abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert float((slab_tile(x) - ref).abs().max()) <= ulp


@pytest.mark.parametrize("L,M", [(32, 32), (64, 128), (256, 256),
                                 (1024, 512), (2048, 64), (4096, 64)])
def test_cuda_amp_slab_matches_plain(cuda_device, L, M):
    """K7 (the slab form, amp_kernel="fused_slab") against its plain
    version, f_b = L below 128 and a cluster of two or four column blocks
    at L = 2048 and 4096: fixed T, early stop, pinning, an SE schedule and
    no encode, to the mono form's bf16 rules; each call counted in
    slab_launches alone."""
    model, y_n, mask, sq, idx = _inputs(L, M, 4, cuda_device, ebno_db=6.0)
    c = model.cfg
    T = 16
    args = (y_n, mask, sq, c.P, c.n, T)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    keep = torch.rand((4, L), generator=gen, device=cuda_device) < 0.4
    pin = torch.where(keep, idx, -1).to(torch.int32)   # decision feedback
    sched = torch.linspace(1.0 + model.sigma2, model.sigma2, T,
                           device=cuda_device)
    launches = (amp_fused.launches, amp_fused.mono_launches,
                amp_fused.slab_launches)
    opts = (dict(), dict(tol=1e-4), dict(tol=1e-4, pin_idx=pin),
            dict(tau2_schedule=sched), dict(encode_idx=None))
    for opt in opts:
        kw = dict(dict(encode_idx=idx, form="slab"), **opt)
        bk, tk, ik = amp_fused(*args, **kw)
        bp, tp, ip = amp_fused_reference(*args, **kw)
        assert bool(torch.isfinite(bk).all() & torch.isfinite(tk).all())
        ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
        if "tol" in opt:    # a bf16 near-tie may set one codeword's stop
            assert abs(float(np.mean(ik - ip))) <= 2, (opt.keys(), ik, ip)
        else:
            np.testing.assert_array_equal(ik, ip)
        t_min = int(min(ik.min(), ip.min()))
        np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                                   tp[:t_min].cpu().numpy(), rtol=2e-2)
        flips, decisive = decision_flips(bp, bk)
        assert decisive == 0
        if kw["encode_idx"] is not None:
            # without a codeword y_n is noise alone: every section is a
            # near-tie there, and K1 flips as many as K7 does
            assert flips <= 0.01 * idx.numel(), (opt.keys(), flips)
        if "pin_idx" in opt:
            rows = pin >= 0
            assert torch.equal(bk[rows], bp[rows])
            assert torch.equal(bk[rows].argmax(-1), pin[rows].long())
        if "tau2_schedule" in opt:
            assert torch.equal(tk, sched[:, None].expand(T, 4))
            assert (ik == T).all()
    assert amp_fused.slab_launches == launches[2] + len(opts)
    assert (amp_fused.launches, amp_fused.mono_launches) == launches[:2]


@pytest.mark.parametrize("kind", ["hand", "empty_rows", "dense",
                                  "dense_l4096", "dense_strip"])
def test_cuda_amp_slab_hand_made_masks_match_plain(cuda_device, kind):
    """K7 keeps y and z on the row support in K1's layout: an empty column,
    empty rows, a full row, a random support of density 0.1 (more entries
    a column block than C1 stages), the same in a cluster of four blocks
    at L = 4096, and a dense strip (more entries a block's rows than R2C2
    stages); against its plain version and a second identical run bit for
    bit."""
    mask = _hand_made_mask(kind)
    args, idx = _support_inputs(mask, 3, cuda_device)
    launches = amp_fused.slab_launches
    for kw in (dict(), dict(tol=1e-4)):
        kw = dict(encode_idx=idx, form="slab", **kw)
        out = amp_fused(*args, 8, **kw)
        again = amp_fused(*args, 8, **kw)
        for a, b in zip(out, again):
            assert torch.equal(a, b)
        _hold_mono(out, amp_fused_reference(*args, 8, **kw), idx,
                   "tol" in kw)
    assert amp_fused.slab_launches == launches + 4


def test_cuda_amp_slab_walker_skips_frozen_codewords(cuda_device):
    """With the early stop codewords freeze at different iterations; K7's
    column launches' walkers skip their items ((codeword, strip) items
    outnumber the walkers); the result keeps the plain version's rules and
    repeats bit for bit."""
    L, M, B = 1024, 64, 192
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert B * (M // 32) > sms
    model, y_n, mask, sq, idx = _inputs(L, M, B, cuda_device, ebno_db=6.0)
    c = model.cfg
    y_n[:B // 2] *= 0.5
    args = (y_n, mask, sq, c.P, c.n, 16)
    kw = dict(encode_idx=idx, form="slab", tol=1e-3)
    out = amp_fused(*args, **kw)
    again = amp_fused(*args, **kw)
    ik = out[2].cpu().numpy()
    assert ik.min() < ik.max(), ik
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    _hold_mono(out, amp_fused_reference(*args, **kw), idx, True)


@pytest.mark.parametrize("L,M,density", [(32, 32, 0.1), (64, 128, 0.05),
                                         (256, 512, 0.02),
                                         (1024, 512, 0.018),
                                         (1024, 64, 0.5), (4096, 128, 0.05)])
def test_cuda_slab_adjoint_matches_plain(cuda_device, L, M, density):
    """K7's adjoint launch alone (each row's H_M from its bf16 entries,
    rounded to bf16, then H_L on the tensor cores): against
    `slab_adjoint_reference`, on integer z bit for bit (every sum exact)
    and on normals to 1e-5 of the output scale; (1024, 64, 0.5) has more
    entries than the launch stages, (4096, 128) runs on clusters of
    four."""
    rng = np.random.default_rng(1)
    mask = torch.tensor(rng.random((L, M)) < density, dtype=torch.float32)
    sp = split_support_from_mask(mask).to(cuda_device)
    B = 3
    for z in (rng.integers(-8, 9, (B, sp.ns)), rng.standard_normal((B, sp.ns))):
        zc = torch.tensor(z, dtype=torch.float32, device=cuda_device)
        ref = slab_adjoint_reference(zc, sp)
        got = slab_adjoint(zc, sp)
        if z.dtype.kind == "i":
            assert torch.equal(got, ref)
        else:
            err = (got - ref).abs().max() / ref.abs().max()
            assert float(err) <= 1e-5, float(err)


def test_cuda_slab_model_block_matches_cpu(cuda_device):
    """A "fused_slab" SparcModel block on the card runs K7 once and agrees
    with the CPU block of the same draws (the plain slab form)."""
    cfg = _config(64, 128).replace(amp_kernel="fused_slab", amp_iters=16,
                                   amp_tol=1e-4)
    cpu = SparcModel.build(cfg, 6.0, "cpu")
    gpu = SparcModel.build(cfg, 6.0, cuda_device)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (8, cfg.k_bits)).astype(np.int32)
    noise = rng.standard_normal((8, cfg.n)).astype(np.float32)
    launches = amp_fused.slab_launches
    a = gpu.run_block_from(bits, noise)
    assert amp_fused.slab_launches == launches + 1
    b = cpu.run_block_from(bits, noise)
    assert a["trials"].item() == b["trials"].item() == 8
    assert abs(a["iters_sum"].item() - b["iters_sum"].item()) <= 16
    np.testing.assert_allclose(a["tau2_final"].item(),
                               b["tau2_final"].item(), rtol=2e-2)


def test_cuda_amp_fused_rejects_what_it_cannot_take(cuda_device):
    model, y_n, mask, sq, idx = _inputs(64, 128, 2, cuda_device)
    c = model.cfg
    with pytest.raises(TypeError):
        amp_fused(y_n, mask, sq, c.P, c.n, 4, encode_idx=idx.long())
    with pytest.raises(ValueError):
        amp_fused(y_n, mask.cpu(), sq, c.P, c.n, 4, encode_idx=idx)
    with pytest.raises(ValueError):
        amp_fused(y_n.transpose(1, 2).contiguous().transpose(1, 2), mask, sq,
                  c.P, c.n, 4)
    with pytest.raises(ValueError):                 # L = 16 is not built
        amp_fused(y_n[:, :16], mask[:16], sq[:16], c.P, c.n, 4)


def test_cuda_slice_matches_cpu_slice(cuda_device):
    cfg = _config(64, 128).replace(power_alloc="iterative",
                                   amp_iters=16, amp_iters_auto=True)
    cpu = SparcModel.build(cfg, 4.0, "cpu")
    gpu = SparcModel.build(cfg, 4.0, cuda_device)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (4, cfg.k_bits)).astype(np.int32)
    noise = rng.standard_normal((4, cfg.n)).astype(np.float32)
    launches = amp_fused.launches
    a = gpu.run_block_from(bits, noise)
    assert amp_fused.launches == launches + 1
    b = cpu.run_block_from(bits, noise)
    for k in ("trials", "iters_sum"):
        assert a[k].item() == b[k].item()
    np.testing.assert_allclose(a["tau2_final"].item(),
                               b["tau2_final"].item(), rtol=2e-2)
    y = torch.tensor(noise) * math.sqrt(cpu.sigma2)
    idx = bits_to_indices(torch.tensor(bits), cfg.logM)
    rg = gpu.decode(y.to(cuda_device), encode_idx=idx.to(cuda_device))
    rc = cpu.decode(y, encode_idx=idx)
    assert decision_flips(rc.beta, rg.beta)[1] == 0


@pytest.mark.parametrize("L,M", [(64, 128), (1024, 512)])
def test_cuda_amp_fused_options_match_plain(cuda_device, L, M):
    """K1 (c) early stop, (d) pinning and the SE schedule, in float32."""
    model, y_n, mask, sq, idx = _inputs(L, M, 4, cuda_device, ebno_db=6.0)
    c = model.cfg
    T = 16
    args = (y_n, mask, sq, c.P, c.n, T)
    kw = dict(encode_idx=idx, precision="highest", split=True)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    pin = torch.randint(0, M, (4, L), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    keep = torch.rand((4, L), generator=gen, device=cuda_device) < 0.4
    pin = torch.where(keep, pin, -1).to(torch.int32)
    sched = torch.linspace(0.5, 0.05, T, device=cuda_device)
    for opt in (dict(tol=1e-4), dict(tol=1e-4, pin_idx=pin),
                dict(tau2_schedule=sched)):
        bk, tk, ik = amp_fused(*args, **kw, **opt)
        bp, tp, ip = amp_fused_reference(*args, **kw, **opt)
        ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
        assert np.abs(ik - ip).max() <= 4, (opt.keys(), ik, ip)
        t_min = int(min(ik.min(), ip.min()))
        np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                                   tp[:t_min].cpu().numpy(), rtol=1e-4)
        assert decision_flips(bp, bk)[1] == 0
        same = torch.tensor(ik == ip, device=cuda_device)
        assert float((bk - bp).abs()[same].max()) <= 1e-3
        if "pin_idx" in opt:
            rows = pin >= 0
            assert torch.equal(bk[rows], bp[rows])
            assert torch.equal(bk[rows].argmax(-1), pin[rows].long())
        if "tau2_schedule" in opt:
            assert torch.equal(tk, sched[:, None].expand(T, 4))
            assert (ik == T).all()
        if "tol" in opt:
            assert ik.max() < T, "the point must stop early"


def _qc_llrs(path_or_z, B, sigma, device, seed=0):
    cfg = (LdpcConfig(kind="array", z=31, rows_b=4, cols_b=24)
           if path_or_z == 31 else LdpcConfig(kind="qc", path=path_or_z))
    code = build_code(cfg)
    shifts, Z = qc_structure(cfg)
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (B, code.k)))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, code.n))
    llr = torch.tensor(2.0 * y / sigma ** 2, dtype=torch.float32,
                       device=device)
    return tuple(tuple(int(s) for s in row) for row in shifts), Z, llr


_BP_CODES = [31, "wifi_n648_r12", "qc_n648_r56", "wifi_n1296_r12",
             "wifi_n1944_r12"]
_BP_ALL = _BP_CODES + ["qc_n648_r23", "qc_n648_r34"]
# (code, method, case): the earlier mixed batches (ids unchanged), then the
# max-iteration sigma, odd batch sizes around the group and queue edges,
# quantised LLRs with -0.0 and +-clip, no iteration, and one straggler
_BP_CASES = (
    [pytest.param(c, m, "mixed", id=f"{c}-{m}")
     for m in ("minsum", "oms") for c in _BP_CODES]
    + [pytest.param(c, m, "max_iters", id=f"{c}-{m}-max_iters")
       for m in ("minsum", "oms")
       for c in (31, "wifi_n648_r12", "qc_n648_r56", "wifi_n1944_r12")]
    + [pytest.param(c, "minsum", f"batch{b}", id=f"{c}-minsum-batch{b}")
       for c in (31, "wifi_n1944_r12") for b in (1, 37, 4097)]
    + [pytest.param(c, m, "ties", id=f"{c}-{m}-ties")
       for m in ("minsum", "oms") for c in _BP_ALL]
    + [pytest.param(c, "minsum", "iters0", id=f"{c}-minsum-iters0")
       for c in (31, "wifi_n1944_r12")]
    + [pytest.param(c, m, "straggler", id=f"{c}-{m}-straggler")
       for m in ("minsum", "oms") for c in (31, "wifi_n1944_r12")])


def _bp_case_llrs(code, case, device):
    """(shifts, Z, llr, iters) of one case of the bitwise K2 test."""
    # rate 1/2 codes at sigma 0.75, the rate ~0.84 codes at 0.5: a mix of
    # frames that decode early and frames that run all 20 iterations
    sigma = 0.75 if "r12" in str(code) else 0.5
    if case == "mixed" or case == "iters0":
        shifts, Z, llr = _qc_llrs(code, 300, sigma, device)
        return shifts, Z, llr, 0 if case == "iters0" else 20
    if case.startswith("batch"):
        shifts, Z, llr = _qc_llrs(code, int(case[5:]), sigma, device)
        return shifts, Z, llr, 20
    if case == "max_iters":
        # no codeword passes its syndrome: every one runs 32 iterations
        shifts, Z, llr = _qc_llrs(code, 512, 2.0, device)
        return shifts, Z, llr, 32
    if case == "ties":
        shifts, Z, llr = _qc_llrs(code, 300, sigma, device, seed=3)
        rng = np.random.default_rng(4)
        llr = torch.round(llr)           # few levels: |m_vc| ties
        planted = torch.tensor(rng.random(tuple(llr.shape)), device=device)
        # +-clip and beyond where the LLR is already strong (its sign right)
        strong = llr.abs() >= 6
        llr = torch.where(strong & (planted >= 0.03) & (planted < 0.3),
                          torch.sign(llr) * 20.0, llr)
        llr = torch.where(strong & (planted >= 0.3) & (planted < 0.4),
                          torch.sign(llr) * 25.0, llr)
        llr[planted < 0.03] = -0.0
        return shifts, Z, llr, 20
    assert case == "straggler"
    # 4095 noise-free codewords pass after iteration 1; one of pure noise
    # runs all 32
    shifts, Z, clean = _qc_llrs(code, 4096, 1e-3, device)
    _, _, noisy = _qc_llrs(code, 1, 2.0, device, seed=1)
    clean = torch.clamp(clean, -8.0, 8.0)
    clean[1234] = noisy[0]
    return shifts, Z, clean, 32


@pytest.mark.parametrize("code,method,case", _BP_CASES)
def test_cuda_bp_kernel_bitwise_matches_plain(cuda_device, code, method,
                                              case):
    """K2 against the plain layered engine, bitwise, for Z = 31, 27, 54
    and 81: hard decisions, ok flags, iteration counts, posteriors (on
    their int32 view, so signed zeros count), one launch a call."""
    shifts, Z, llr, iters = _bp_case_llrs(code, case, cuda_device)
    launches = bp_decode_qc_kernel.launches
    rk = bp_decode_qc_kernel(llr, shifts, Z, iters=iters, method=method)
    assert bp_decode_qc_kernel.launches == launches + 1
    rp = bp_decode_qc(llr, QcBpTables.build(np.asarray(shifts), Z,
                                            device=cuda_device),
                      iters=iters, method=method, schedule="layered")
    for f in ("hard", "ok", "iters"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f
    assert torch.equal(rk.posterior.view(torch.int32),
                       rp.posterior.view(torch.int32))
    if case == "max_iters":
        assert not rk.ok.any() and (rk.iters == iters).all()
    elif case == "straggler":
        assert int(rk.iters[1234]) == iters and not bool(rk.ok[1234])
        assert int((rk.iters == 1).sum()) == llr.shape[0] - 1
    elif case == "iters0":
        assert not rk.ok.any() and (rk.iters == 0).all()
    elif case in ("mixed", "ties"):
        assert rk.ok.any()


def test_cuda_bp_kernel_rejects_what_it_cannot_take(cuda_device):
    shifts, Z, llr = _qc_llrs("wifi_n648_r12", 4, 0.7, cuda_device)
    with pytest.raises(TypeError):
        bp_decode_qc_kernel(llr.double(), shifts, Z)
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr[:, :-1], shifts, Z)
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr.t().contiguous().t(), shifts, Z)


def test_cuda_concat_block_matches_cpu(cuda_device):
    """ConcatModel.run_block_from on the card against the CPU port on the
    same draws: both kernels launched, the same trial count, bp_ok and
    counters close (bf16 AMP rounding differs between the kernel and the
    plain version, so decisions agree in distribution)."""
    cfg = ConcatConfig(
        sparc=SparcConfig(L=64, M=64, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_iters=16),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        engine="qc", schedule="layered", bp_iters=16),
        f_prot=0.5)
    cpu = ConcatModel.build(cfg, 4.0, "cpu")
    gpu = ConcatModel.build(cfg, 4.0, cuda_device)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (16, cpu.k_user)).astype(np.int32)
    noise = rng.standard_normal((16, cfg.sparc.n)).astype(np.float32)
    launches = (amp_fused.launches, bp_decode_qc_kernel.launches)
    a = {k: v.item() for k, v in gpu.run_block_from(bits, noise).items()}
    assert amp_fused.launches == launches[0] + 2
    assert bp_decode_qc_kernel.launches == launches[1] + 1
    b = {k: v.item() for k, v in cpu.run_block_from(bits, noise).items()}
    assert a["trials"] == b["trials"] == 16
    assert abs(a["bp_ok"] - b["bp_ok"]) <= 1
    assert abs(a["frame_errors"] - b["frame_errors"]) <= 2
    assert abs(a["iters_sum"] - b["iters_sum"]) <= 4 * 16


def _seeds(B, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (B, 2), generator=gen,
                         dtype=torch.int32, device=device)


@pytest.mark.parametrize("L,M", [(64, 128), (1024, 512), (4096, 512)])
def test_cuda_noise_matches_plain(cuda_device, L, M):
    """K1 (e): the kernel's Philox uniforms equal the plain version's, its
    masked normals agree within 1e-5 and are zero off the row support."""
    model, _, mask, _, _ = _inputs(L, M, 2, cuda_device)
    seeds = _seeds(64, cuda_device)
    u1k, thk = noise_uniforms(seeds, L, M)
    u1p, thp = noise_uniforms_reference(seeds, L, M)
    assert torch.equal(u1k, u1p) and torch.equal(thk, thp)
    launches = channel_noise.launches
    zk = channel_noise(seeds, mask, 0.7)
    assert channel_noise.launches == launches + 1
    zp = channel_noise_reference(seeds, mask, 0.7)
    assert float((zk - zp).abs().max()) <= 1e-5
    assert bool((zk[:, mask == 0] == 0).all())
    on = zk[:, mask > 0]
    assert abs(float(on.var()) / 0.49 - 1) < 0.05


def test_cuda_noise_route_matches_plain(cuda_device):
    """amp_fused with noise seeds against its plain version (float32):
    the same noise, so the same decode to summation order."""
    model, _, mask, sq, idx = _inputs(64, 128, 4, cuda_device, ebno_db=6.0)
    c = model.cfg
    seeds = _seeds(4, cuda_device, 1)
    kw = dict(encode_idx=idx, precision="highest", tol=1e-4, split=True,
              noise_seed=seeds, noise_sigma=math.sqrt(model.sigma2))
    bk, tk, ik = amp_fused(None, mask, sq, c.P, c.n, 16, **kw)
    bp, tp, ip = amp_fused_reference(None, mask, sq, c.P, c.n, 16, **kw)
    assert np.abs(ik.cpu().numpy() - ip.cpu().numpy()).max() <= 4
    t_min = int(min(ik.min(), ip.min()))
    np.testing.assert_allclose(tk[:t_min].cpu().numpy(),
                               tp[:t_min].cpu().numpy(), rtol=1e-4)
    assert decision_flips(bp, bk)[1] == 0


@pytest.mark.parametrize("B", [1, 3, 37])
@pytest.mark.parametrize("N", [1 << 11, 1 << 13, 1 << 17, 1 << 19, 1 << 20])
def test_cuda_fwht2_matches_plain(cuda_device, N, B):
    """K5 at batches that fill no whole wave of its column launch's
    blocks, up to N = 2^20: normals within 1e-5 of the scale, with and
    without the bf16 input, and integer inputs bit for bit (every sum
    exact in float32)."""
    gen = torch.Generator(device=cuda_device).manual_seed(N + B)
    x = torch.randn((B, N), generator=gen, device=cuda_device)
    launches = fwht2.launches
    for bf16 in (False, True):
        ref = fwht2_reference(x, bf16)
        err = (fwht2(x, bf16) - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-5, (bf16, float(err))
    ints = torch.randint(-8, 9, (B, N), generator=gen,
                         device=cuda_device).float()
    assert torch.equal(fwht2(ints), fwht2_reference(ints))
    assert fwht2.launches == launches + 3


def test_cuda_fwht2_routes_like_the_reference(cuda_device):
    """One factor (N <= 2^10) or three (N > 2^20): the plain fwht_kron,
    as fwht_pallas falls back to fwht_mxu; what the kernel cannot take
    raises."""
    launches = fwht2.launches
    for N in (1 << 10, 1 << 21):
        x = torch.randn((2, N), device=cuda_device)
        assert torch.equal(fwht2(x), fwht2_reference(x))
    assert fwht2.launches == launches
    with pytest.raises(ValueError):
        fwht2(torch.randn((2, 1 << 12), device=cuda_device).double())
    with pytest.raises(ValueError):
        fwht2(torch.randn((1 << 12, 2), device=cuda_device).t())


@pytest.mark.parametrize("L,M", [(32, 64), (256, 512), (64, 1024)])
def test_cuda_denoise_kernel_matches_plain(cuda_device, L, M):
    B = 6
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    s = 3.0 * torch.randn((B, L, M), generator=gen, device=cuda_device)
    tau2 = torch.logspace(-3, math.log10(2.0), B, device=cuda_device)
    sq = 10.0 + 20.0 * torch.rand((L,), generator=gen, device=cuda_device)
    launches = denoise_kernel.launches
    bk, pk = denoise_kernel(s, tau2, sq)
    assert denoise_kernel.launches == launches + 1
    bp, pp = denoise(s, tau2, sq)
    assert bool(torch.isfinite(bk).all() & torch.isfinite(pk).all())
    torch.testing.assert_close(bk, bp, rtol=1e-5,
                               atol=1e-6 * float(sq.max()))
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-7)


def test_cuda_pallas_route_matches_cpu(cuda_device):
    """The --pallas scan route on the card (fwht2 and the denoiser kernel
    every iteration) against the CPU port on the same observation."""
    cfg = SparcConfig(L=32, M=64, R=1.0, power_alloc="iterative",
                      op_kind="hadamard", amp_iters=16, amp_tol=0.0)
    cpu = SparcModel.build(cfg, 6.0, "cpu", use_pallas=True)
    gpu = SparcModel.build(cfg, 6.0, cuda_device, use_pallas=True)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (4, cfg.k_bits)).astype(np.int32)
    noise = rng.standard_normal((4, cfg.n)).astype(np.float32)
    x = cpu.encode(torch.tensor(bits))
    y = x + torch.tensor(noise) * math.sqrt(cpu.sigma2)
    launches = (fwht2.launches, denoise_kernel.launches, amp_fused.launches)
    rg = gpu.decode(y.to(cuda_device))
    assert fwht2.launches == launches[0] + 2 * 16
    assert denoise_kernel.launches == launches[1] + 16
    assert amp_fused.launches == launches[2]
    rc = cpu.decode(y)
    np.testing.assert_allclose(rg.tau2_trace.cpu().numpy(),
                               rc.tau2_trace.numpy(), rtol=1e-4)
    assert decision_flips(rc.beta, rg.beta)[1] == 0


def test_cuda_concat_noise_route_runs_both_kernels(cuda_device):
    """The shipped concat options with in-kernel noise on the card: both
    AMP passes and BP launch, and the same generator gives the same
    counters."""
    cfg = ConcatConfig(
        sparc=SparcConfig(L=64, M=64, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_iters=16, amp_noise_in_kernel=True),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        engine="qc", schedule="layered", bp_iters=16),
        f_prot=0.5)
    gpu = ConcatModel.build(cfg, 4.0, cuda_device)
    launches = (amp_fused.launches, bp_decode_qc_kernel.launches)

    def run():
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        return {k: v.item() for k, v in gpu.run_block(gen, 16).items()}

    a = run()
    assert amp_fused.launches == launches[0] + 2
    assert bp_decode_qc_kernel.launches == launches[1] + 1
    assert a == run() and a["trials"] == 16


def test_cuda_run_block_returns_before_the_device_finishes(cuda_device):
    """run_block only queues work: the campaign launches block b + 1 before
    it reads block b's counters.  A host-to-device copy inside the block
    (torch.tensor(..., device=cuda) waits for the stream) would make it
    return only once the block has run."""
    import time

    cfg = SparcConfig(L=1024, M=512, R=1.0, op_kind="hadamard",
                      amp_kernel="fused_split", transform_precision="bf16",
                      amp_iters=16, amp_tol=0.0, amp_noise_in_kernel=True)
    model = SparcModel.build(cfg, 4.0, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model.run_block(gen, 256)                      # warm-up, build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.run_block(gen, 256)
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    assert out["trials"].item() == 256
    assert queued < 0.5 * done, (queued, done)


# ------------------------------------------------ the multi-device path

@pytest.mark.parametrize("L", [512, 2048])
def test_cuda_fwht_tile_with_scale_matches_plain(cuda_device, L):
    """K3: in bf16 on integer inputs bit for bit (every sum is exact, so
    only the rounding points count, and they are the plain version's);
    on normals in float32 to 1e-5 of the output scale."""
    M = 512
    scale = 1.0 / math.sqrt(L * M / 2)
    ints = torch.randint(-8, 9, (2, L, M), device=cuda_device).float()
    launches = fwht_tile.launches
    assert torch.equal(fwht_tile(ints, "bf16", scale),
                       fwht_tile_reference(ints, "bf16") * scale)
    x = torch.randn((2, L, M), device=cuda_device)
    ref = fwht_tile_reference(x, "highest") * scale
    err = (fwht_tile(x, "highest", scale) - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5
    assert fwht_tile.launches == launches + 2


def _bf16_flip_limit(x, scale):
    """One bf16 ulp of the largest H_M value, times the scale: K3 and its
    plain version both round the H_M stage's values before H_L, but sum in
    other orders, so a rounding may fall to the other neighbour."""
    v = float(fwht_kron(round_bf16(x), "highest", -1).abs().max())
    return scale * 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.mark.parametrize("L", [32, 64, 256, 512, 1024, 2048, 4096])
def test_cuda_fwht_tile_every_path(cuda_device, L):
    """K3 on every path it takes: in bf16 the one-pass cluster of M / 32
    blocks a codeword at l <= 256 and M <= 512 (one block at M = 32, 16
    at 512), and the row and column launches above (M = 1024, l >= 512;
    at 2048 and 4096 the column launch on a cluster of two and four blocks
    a strip),
    the row stage's warp layouts (M = 32, 64, 512 and 1024); float32 to
    1e-5 of the output scale, bf16 on integer inputs bit for bit and on
    normals within one bf16 ulp of the largest H_M value."""
    scale = 1.0 / math.sqrt(L * 64)
    for M in (32, 64, 512, 1024):
        B = 3 if L * M <= 2 ** 17 else 1
        x = torch.randn((B, L, M), device=cuda_device)
        ref = fwht_tile_reference(x, "highest") * scale
        err = (fwht_tile(x, "highest", scale) - ref).abs().max()
        assert float(err / ref.abs().max()) <= 1e-5, (M, float(err))
        err = (fwht_tile(x, "bf16", scale)
               - fwht_tile_reference(x, "bf16") * scale).abs().max()
        assert float(err) <= _bf16_flip_limit(x, scale), (M, float(err))
        ints = torch.randint(-8, 9, (B, L, M), device=cuda_device).float()
        assert torch.equal(fwht_tile(ints, "bf16", scale),
                           fwht_tile_reference(ints, "bf16") * scale), M


def test_cuda_fwht_tile_repeats_bit_for_bit(cuda_device):
    """K3's column launch walks (codeword, strip) items when they outnumber
    its resident walkers; two calls give the same bits."""
    x = torch.randn((64, 1024, 512), device=cuda_device)
    assert torch.equal(fwht_tile(x, "bf16", 0.5), fwht_tile(x, "bf16", 0.5))


def test_cuda_data_parallel_block_is_bitwise_the_single_device(cuda_device):
    """K1 computes each codeword alone with fixed-order sums and its own
    Philox key, so a virtual (4, 1) mesh of the card gives the single
    device's block bit for bit, tau2_final included."""
    import dataclasses

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    cfg = SparcConfig(L=256, M=256, R=1.0, op_kind="hadamard",
                      amp_kernel="fused_split", transform_precision="bf16",
                      amp_iters=8, amp_tol=0.0, amp_noise_in_kernel=True)
    model = SparcModel.build(cfg, 5.0, cuda_device)

    def run(m):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        return {k: v.item() for k, v in m.run_block(gen, 64).items()}

    want = run(model)
    dp = dataclasses.replace(model, policy=ShardingPolicy(
        make_mesh(1, [cuda_device] * 4)))
    launches = amp_fused.noise_launches
    assert run(dp) == want
    assert amp_fused.noise_launches == launches + 4


@pytest.mark.parametrize("S", [2, 4])
def test_cuda_section_sharded_amp_matches_plain(cuda_device, S):
    """The section-sharded loop on a virtual (1, S) mesh of the card (K3
    and K4) against the same loop on the CPU (their plain versions), same
    inputs: margin-aware decisions, tau2 to rtol 2e-2 (bf16), K3 launched
    twice an iteration on every slab."""
    from sparc_ldpc_tpu_torch.parallel.amp_sharded import amp_fused_sharded
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    L, M, B = 256, 256, 8
    model, y_n, mask, sq, idx = _inputs(L, M, B, "cpu")
    c = model.cfg
    beta0 = model.build_beta(idx).reshape(B, L, M)
    y_n = y_n + mask * fwht_tile_reference(beta0) / math.sqrt(c.n)
    args = (c.P, c.n, c.amp_iters)

    def run(dev):
        pol = ShardingPolicy(make_mesh(S, [dev] * S))
        beta, trace, iters = zip(*amp_fused_sharded(
            y_n.to(dev), mask.to(dev), sq.to(dev), *args, pol))
        return (pol.gather(beta, 0), pol.gather(trace, 1),
                pol.gather(iters, 0))

    bp, tp, _ = run("cpu")
    launches = fwht_tile.launches
    bk, tk, ik = run(cuda_device)
    assert fwht_tile.launches == launches + 2 * c.amp_iters * S
    assert decision_flips(bp, bk)[1] == 0
    np.testing.assert_allclose(tk.cpu().numpy(), tp.numpy(), rtol=2e-2)
    assert torch.equal(ik.cpu(), torch.full((B,), c.amp_iters,
                                            dtype=torch.int32))


def test_cuda_kernels_launch_on_their_tensors_device(cuda_device):
    """A wrapper launches on its tensors' device whatever device is
    current (a process of a multi-GPU mesh holds tensors on several)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs; on one card the virtual meshes above "
                    "run the same code")
    dev = torch.device("cuda", 1)
    x = torch.randn((2, 64, 128), device=dev)
    tau2 = torch.full((2,), 0.5, device=dev)
    sq = torch.ones(64, device=dev)
    with torch.cuda.device(0):
        got = fwht_tile(x, "highest", 0.5)
        beta, _ = denoise_kernel(x, tau2, sq)
    torch.cuda.synchronize(dev)
    ref = fwht_tile_reference(x, "highest") * 0.5
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    torch.testing.assert_close(beta, denoise(x, tau2, sq)[0], rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------ real meshes of several GPUs
#
# Every kernel computes each codeword, or each slab, alone and in a fixed
# order, so a mesh of real GPUs gives exactly what the same mesh made
# virtual on cuda:0 gives; a difference is a fault in the copies between
# cards.  These skip on one card.

@pytest.fixture
def gpus(cuda_device):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two GPUs or more; on one card the virtual "
                    "meshes above run the same code")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh_model(device):
    cfg = SparcConfig(L=256, M=256, R=1.0, op_kind="hadamard",
                      amp_kernel="fused_split", transform_precision="bf16",
                      amp_iters=8, amp_tol=0.0, amp_noise_in_kernel=True)
    return SparcModel.build(cfg, 5.0, device)


def _campaign_argv(n):
    """A small fused campaign whose blocks divide over n GPUs."""
    return ["campaign", "--preset", "plain_small", "--fused", "--ebno",
            "5.0", "--batch", str(4 * n), "--max-trials", str(12 * n),
            "--min-frame-errors", "1000000", "--amp-iters", "8"]


CAMPAIGN_KEYS = ("bit_errors", "frame_errors", "trials", "bit_errors_sq",
                 "blocks", "mean_iters")


def test_cuda_real_mesh_data_parallel_is_bitwise_one_card(gpus):
    """A data shard on every GPU (K1 with its noise on each, the decisions
    taken there and gathered on cuda:0): the block of cuda:0 alone,
    tau2_final included."""
    import dataclasses

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    model = _mesh_model(gpus[0])

    def run(m):
        gen = torch.Generator(device=gpus[0]).manual_seed(5)
        out = m.run_block(gen, 16 * len(gpus))
        return {k: v.item() for k, v in out.items()}

    want = run(model)
    real = dataclasses.replace(model, policy=ShardingPolicy(
        make_mesh(1, gpus)))
    assert run(real) == want


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_real_mesh_frames_are_one_cards_without_beta_home(gpus, n):
    """frame_counts on a real (n, 1) mesh (K1 with its noise on each card,
    each card's argmax there, only the int32 indices, trace and
    iterations copied to cuda:0): every per-frame output of cuda:0 alone
    on the same seeds, bit for bit, and cuda:0's peak over the call stays
    below the size of the whole batch's beta, which it held before the
    decisions moved to the cards."""
    import dataclasses

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    if len(gpus) < n:
        pytest.skip(f"needs {n} GPUs, {len(gpus)} visible")
    model = _mesh_model(gpus[0])
    c, B = model.cfg, 64 * n
    gen = torch.Generator(device=gpus[0]).manual_seed(11)
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=gpus[0])
    seeds = model.draw_seeds(gen, B)
    want = model.frame_counts(bits, None, noise_seed=seeds)
    mesh = dataclasses.replace(model, policy=ShardingPolicy(
        make_mesh(1, gpus[:n])))
    torch.cuda.synchronize(gpus[0])
    torch.cuda.reset_peak_memory_stats(gpus[0])
    base = torch.cuda.memory_allocated(gpus[0])
    got = mesh.frame_counts(bits, None, noise_seed=seeds)
    for d in gpus[:n]:
        torch.cuda.synchronize(d)
    peak = torch.cuda.max_memory_allocated(gpus[0]) - base
    for k in want:
        assert got[k].device == gpus[0], k
        assert torch.equal(got[k], want[k]), k
    assert peak < B * c.L * c.M * 4, peak


@pytest.mark.parametrize("S", [2, 4])
def test_cuda_real_mesh_section_sharded_equals_virtual(gpus, S):
    """The sharded loop on a real (n/S, S) mesh (K3 and K4 on every card,
    the hypercube's slabs copied between cards) against the same mesh made
    virtual on cuda:0: beta, trace and iterations bit for bit."""
    import dataclasses

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    n = len(gpus)
    if n % S:
        pytest.skip(f"needs a multiple of {S} GPUs, {n} visible")
    model = _mesh_model(gpus[0])
    c = model.cfg
    B = 4 * n
    gen = torch.Generator(device=gpus[0]).manual_seed(7)
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=gpus[0])
    y = model.encode(bits) + math.sqrt(model.sigma2) * torch.randn(
        (B, c.n), generator=gen, device=gpus[0])
    out = {name: dataclasses.replace(model, policy=ShardingPolicy(
        make_mesh(S, devs))).decode(y)
        for name, devs in (("real", gpus), ("virtual", [gpus[0]] * n))}
    for f in ("beta", "tau2_trace", "iters"):
        assert torch.equal(getattr(out["real"], f),
                           getattr(out["virtual"], f)), f


def test_cuda_cli_mesh_spans_every_gpu(gpus, tmp_path, monkeypatch):
    """`campaign --section-shards 2` with n GPUs visible runs on an (n/2, 2)
    mesh of them, with the counters of that mesh made virtual on cuda:0."""
    import json

    from sparc_ldpc_tpu_torch import cli

    n = len(gpus)
    recs = {}
    for name in ("real", "virtual"):
        if name == "virtual":
            monkeypatch.setattr(cli, "_process_gpus",
                                lambda distributed: [gpus[0]] * n)
        out = tmp_path / f"{name}.jsonl"
        assert cli.main([*_campaign_argv(n), "--section-shards", "2",
                         "--out", str(out)]) == 0
        recs[name] = json.loads(out.read_text().splitlines()[-1])
    assert recs["real"]["mesh"] == recs["virtual"]["mesh"] == [n // 2, 2]
    assert ({k: recs["real"][k] for k in CAMPAIGN_KEYS}
            == {k: recs["virtual"][k] for k in CAMPAIGN_KEYS})


def test_cuda_distributed_processes_share_the_gpus(gpus, tmp_path):
    """Two `--distributed` processes started by torch.distributed.run, each
    driving its half of the GPUs as an (n/2, 1) mesh, give the counters of
    one process on cuda:0 alone; rank 0 alone writes."""
    import json
    import os
    import socket
    import subprocess
    import sys

    n = len(gpus)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def campaign(out, launcher, env):
        proc = subprocess.run(
            [sys.executable, *launcher, "-m", "sparc_ldpc_tpu_torch.cli",
             *_campaign_argv(n), "--out", str(out)]
            + (["--distributed"] if launcher else []),
            cwd=repo, env=dict(os.environ, **env), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return [json.loads(x) for x in out.read_text().splitlines()]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    one = campaign(tmp_path / "one.jsonl", [], {"CUDA_VISIBLE_DEVICES": "0"})
    two = campaign(tmp_path / "two.jsonl",
                   ["-m", "torch.distributed.run", "--nproc_per_node", "2",
                    "--master_addr", "127.0.0.1", "--master_port",
                    str(port)], {})
    assert len(two) == 1
    assert two[0]["processes"] == 2 and two[0]["mesh"] == [n // 2, 1]
    assert ({k: two[0][k] for k in CAMPAIGN_KEYS}
            == {k: one[-1][k] for k in CAMPAIGN_KEYS})


# ------------------------------- a section axis across processes, one card

_NCCL_PAIR = """
import os, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="env://")
torch.cuda.set_device(0)
g = dist.new_group([0, 1], backend="nccl")
r = dist.get_rank()
x = torch.full((4,), float(r), device="cuda:0")
y = torch.empty_like(x)
ops = [dist.P2POp(dist.isend, x, 1 - r, g), dist.P2POp(dist.irecv, y, 1 - r, g)]
for w in dist.batch_isend_irecv(ops):
    w.wait()
torch.cuda.synchronize()
print("received", y.tolist(), flush=True)
"""


def _two_ranks(code, port, timeout=120):
    """Two processes of `code` with torch.distributed.run's environment;
    their (returncode, stdout, stderr)."""
    import os
    import subprocess
    import sys

    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        outs.append((p.returncode, so, se))
    return outs


def _port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cuda_nccl_refuses_two_ranks_of_one_gpu(cuda_device):
    """What the CLI's --dist-backend nccl check stands on: NCCL between two
    ranks of one GPU fails ("Duplicate GPU detected") rather than
    exchanging."""
    outs = _two_ranks(_NCCL_PAIR, _port())
    assert all(rc != 0 for rc, _, _ in outs), outs
    assert any("Duplicate GPU" in so + se for _, so, se in outs), [
        se[-2000:] for _, _, se in outs]


def test_cuda_cli_section_axis_across_processes_of_one_card(cuda_device,
                                                            tmp_path):
    """Two --distributed CLI processes sharing cuda:0 with --section-shards
    2: with the default backend (nccl) the CLI exits with its message;
    with --dist-backend gloo the record equals one process's with S = 2
    on a virtual (1 x 2) mesh (the CLI in one process on one GPU
    refuses S = 2, so the campaign runs in process)."""
    import json
    import os
    import subprocess
    import sys

    from sparc_ldpc_tpu_torch.config import PRESETS, CampaignConfig
    from sparc_ldpc_tpu_torch.models.sparc import SparcSweep
    from sparc_ldpc_tpu_torch.parallel.campaign import run_campaign
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["campaign", "--preset", "plain_small", "--fused", "--ebno",
            "5.0", "--batch", "8", "--max-trials", "16",
            "--min-frame-errors", "1000000", "--amp-iters", "8",
            "--section-shards", "2", "--distributed"]

    def launch(out, *extra):
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
             "2", "--master_addr", "127.0.0.1", "--master_port", str(_port()),
             "-m", "sparc_ldpc_tpu_torch.cli", *argv, "--out", str(out),
             *extra], cwd=repo, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))

    refused = launch(tmp_path / "nccl.jsonl")
    assert refused.returncode != 0
    assert "NCCL refuses two ranks of one GPU" in refused.stderr
    proc = launch(tmp_path / "gloo.jsonl", "--dist-backend", "gloo")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dist_backend=gloo" in proc.stdout
    recs = [json.loads(x)
            for x in (tmp_path / "gloo.jsonl").read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["section_processes"] == 2
    # the CLI's --fused --amp-iters 8 on plain_small
    cfg = PRESETS["plain_small"].replace(
        amp_kernel="fused_split", amp_tol=0.0, transform_precision="bf16",
        amp_iters=8)
    pol = ShardingPolicy(make_mesh(2, [cuda_device] * 2))
    sweep = SparcSweep(cfg, device=cuda_device, policy=pol)
    ref = run_campaign(sweep.model_for_point,
                       CampaignConfig(ebno_grid_db=(5.0,), batch=8,
                                      min_frame_errors=1_000_000,
                                      max_trials=16, base_seed=1234,
                                      section_shards=2),
                       lambda m: m.cfg.k_bits, policy=pol, verbose=False)[0]
    assert ({k: recs[0][k] for k in CAMPAIGN_KEYS}
            == {k: ref[k] for k in CAMPAIGN_KEYS})


# ------------------------------------- the split kernel's experiments

@pytest.fixture(scope="module")
def exp_draws():
    """The scripts' model (L=1024, M=512, 2.0 dB) and 8 codewords' draws
    from NumPy, on the CPU."""
    from sparc_ldpc_tpu_torch.tools.kernel_ablation import script_config

    model = SparcModel.build(script_config(), 2.0, "cpu")
    c = model.cfg
    rng = np.random.default_rng(0)
    bits = torch.tensor(rng.integers(0, 2, (8, c.k_bits)), dtype=torch.int32)
    noise = torch.tensor(rng.standard_normal((8, c.n)), dtype=torch.float32)
    y = model.encode(bits) + noise * math.sqrt(model.sigma2)
    return (model, model.op.embed_y(y).reshape(8, c.L, c.M),
            bits_to_indices(bits, c.logM))


@pytest.mark.parametrize("mode", MODES)
def test_cuda_amp_exp_matches_plain(cuda_device, exp_draws, mode):
    model, y_n, idx = exp_draws
    c = model.cfg
    L, M = c.L, c.M
    args = (y_n.to(cuda_device), model.op.mask.reshape(L, M).to(cuda_device),
            model.sq_npl.to(cuda_device), c.P, c.n)
    ablated = mode in ABLATED
    T = 2 if ablated else 32
    precs = (("highest", "bf16") if ablated or mode in ("full", "pair")
             else ("bf16",))
    for prec in precs:
        bk, tk = amp_exp(mode, *args, T, prec)
        order = ("kernel" if mode == "pair" or (ablated and prec == "bf16")
                 else "script")
        bp, tp = amp_exp_reference(mode, *args, T, mode_f_b(mode, L),
                                   mode == "pair", prec, order)
        torch.cuda.synchronize()
        assert tk.shape == tp.shape == (T, 4 if mode == "pair" else 8)
        if ablated:
            assert torch.equal(torch.isnan(bk), torch.isnan(bp))
            fin = ~torch.isnan(bp)
            err = (bk - bp)[fin].abs().max() / bp[fin].abs().max()
            assert float(err) <= 1e-2, (prec, float(err))
            continue
        assert bool(torch.isfinite(bk).all() & torch.isfinite(tk).all())
        flips, decisive = decision_flips(bk, bp)
        assert flips <= 0.01 * 8 * L, (prec, flips)
        rel = float(((tk - tp).abs() / tp).max())
        assert rel <= (1e-4 if prec == "highest" else 2e-2), (prec, rel)
        if prec == "highest":
            assert decisive == 0


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_cuda_amp_exp_full_is_k1_bit_for_bit(cuda_device, exp_draws, prec):
    """S2's full is K1's own kernels at their default variant: its beta and
    tau2 trace are K1's fixed-T call with y given (amp_fused, split form,
    the same support tables), bit for bit; and every S2 and S3 variant
    gives the same bits without the tables (built from the mask)."""
    model, y_n, _ = exp_draws
    c = model.cfg
    L, M = c.L, c.M
    sup = model.op.split_support(L, M, cuda_device)
    args = (y_n.to(cuda_device), model.op.mask.reshape(L, M).to(cuda_device),
            model.sq_npl.to(cuda_device), c.P, c.n, 6)
    bk, tk, _ = amp_fused(*args, precision=prec, split=True, support=sup)
    be, te = amp_exp("full", *args, prec, sup)
    assert torch.equal(be, bk) and torch.equal(te, tk)
    modes = S2_MODES + (S3_MODES if prec == "bf16" else ())
    for mode in modes:
        want = amp_exp(mode, *args, prec, sup)
        got = amp_exp(mode, *args, prec)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0])), mode
        assert torch.equal(got[0].nan_to_num(), want[0].nan_to_num()), mode
        assert torch.equal(got[1].nan_to_num(), want[1].nan_to_num()), mode


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_cuda_amp_exp_pair_is_k1_bit_for_bit(cuda_device, exp_draws, prec):
    """S1's pair is K1's column stage and K1's row stage at its paired
    variant: its beta is K1's fixed-T call's (amp_fused, split form) bit for
    bit, its trace K1's of the first codeword of each pair."""
    model, y_n, _ = exp_draws
    c = model.cfg
    L, M = c.L, c.M
    sup = model.op.split_support(L, M, cuda_device)
    args = (y_n.to(cuda_device), model.op.mask.reshape(L, M).to(cuda_device),
            model.sq_npl.to(cuda_device), c.P, c.n, 6)
    bk, tk, _ = amp_fused(*args, precision=prec, split=True, support=sup)
    before = amp_exp.launches["pair"]
    bp, tp = amp_exp("pair", *args, prec, sup)
    assert amp_exp.launches["pair"] == before + 1
    assert torch.equal(bp, bk) and torch.equal(tp, tk[:, 0::2])


def test_cuda_amp_exp_rejects_what_it_cannot_take(cuda_device):
    mask, sq = torch.ones((256, 64), device=cuda_device), torch.ones(
        256, device=cuda_device)
    with pytest.raises(ValueError, match="L = 1024"):
        amp_exp("full", torch.zeros((2, 256, 64), device=cuda_device), mask,
                sq, 1.0, 1536, 2)
    y = torch.zeros((2, 1024, 512), device=cuda_device)
    mask, sq = torch.ones((1024, 512), device=cuda_device), torch.ones(
        1024, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        amp_exp("slab_loop", y, mask, sq, 1.0, 9216, 2, "highest")
    with pytest.raises(TypeError):
        amp_exp("full", y.double(), mask, sq, 1.0, 9216, 2)


# ------------------------------------- the slab kernel's stage ablation

@pytest.mark.parametrize("mode", SLAB_MODES)
def test_cuda_amp_slab_exp_matches_plain(cuda_device, exp_draws, mode):
    """Each S4 variant against its plain version on 8 encoded codewords,
    one kernel run counted per call."""
    model, y_n, _ = exp_draws
    c = model.cfg
    L, M = c.L, c.M
    mask = (compact_mask(L, M, c.n)
            if parse_mode(mode, L, M, c.n).base == "compact"
            else model.op.mask.reshape(L, M))
    args = (y_n.to(cuda_device), mask.to(cuda_device),
            model.sq_npl.to(cuda_device), c.P, c.n)
    ablated = mode in SLAB_ABLATED
    T = 2 if ablated else 32
    before = amp_slab_exp.launches[mode]
    bk, tk = amp_slab_exp(mode, *args, T)
    assert amp_slab_exp.launches[mode] == before + 1
    bp, tp = amp_slab_exp_reference(mode, *args, T, order="kernel")
    torch.cuda.synchronize()
    assert tk.shape == tp.shape == (T, 4 if mode == "pair" else 8)
    if ablated:
        assert torch.equal(torch.isnan(bk), torch.isnan(bp))
        if mode == "no_consume":    # its first tau2 is 0: NaN throughout
            assert bool(torch.isnan(bp).all())
            return
        assert not bool(torch.isnan(bp).any())
        err = (bk - bp).abs().max() / bp.abs().max()
        assert float(err) <= 1e-2, float(err)
        return
    assert bool(torch.isfinite(bk).all() & torch.isfinite(tk).all())
    flips, _ = decision_flips(bk, bp)
    assert flips <= 0.01 * 8 * L, flips
    if mode == "no_trace":
        assert not bool(tk.any())
    else:
        assert float(((tk - tp).abs() / tp).max()) <= 2e-2


def _slab_args(model, y_n, dev):
    c = model.cfg
    return (y_n.to(dev), model.op.mask.reshape(c.L, c.M).to(dev),
            model.sq_npl.to(dev), c.P, c.n)


@pytest.mark.parametrize("mode", ["full", "pair", "sched", "fold",
                                  "no_trace"])
def test_cuda_amp_slab_exp_resumes_bit_for_bit(cuda_device, exp_draws, mode):
    """One iteration, its state kept, then one more from that state: the
    same bits as two iterations in one run (the resume rebuilds the work
    tile with K7's H_M launch and sums |beta'|^2 in slab order, as the run
    does)."""
    model, y_n, _ = exp_draws
    args = _slab_args(model, y_n, cuda_device)
    b2, t2 = amp_slab_exp(mode, *args, 2)
    b1, t1, state = amp_slab_exp(mode, *args, 1, keep_state=True)
    br, tr = amp_slab_exp(mode, *args, 1, state=state)
    assert torch.equal(br, b2)
    assert torch.equal(torch.cat([t1, tr]), t2)


def test_cuda_amp_slab_exp_full_is_k7_bit_for_bit(cuda_device, exp_draws):
    """S4's full is K7's own kernels at their default variant: its beta
    and trace are K7's fixed-T call with y given (amp_fused, slab form),
    bit for bit, with or without the support tables."""
    model, y_n, _ = exp_draws
    c = model.cfg
    args = _slab_args(model, y_n, cuda_device) + (6,)
    sup = model.op.split_support(c.L, c.M, cuda_device)
    bk, tk, _ = amp_fused(*args, form="slab", support=sup)
    for s in (sup, None):
        bs, ts = amp_slab_exp("full", *args, support=s)
        assert torch.equal(bs, bk) and torch.equal(ts, tk)


def test_cuda_amp_slab_exp_pair_is_full_bit_for_bit(cuda_device, exp_draws):
    """Two codewords a block give full's bits: beta, the kept state, and
    the trace of the first codeword of each pair."""
    model, y_n, _ = exp_draws
    args = _slab_args(model, y_n, cuda_device)
    bf, tf, sf = amp_slab_exp("full", *args, 32, keep_state=True)
    bp, tp, sp = amp_slab_exp("pair", *args, 32, keep_state=True)
    assert torch.equal(bp, bf) and torch.equal(tp, tf[:, 0::2])
    assert all(torch.equal(a, b) for a, b in zip(sf, sp))


def test_cuda_amp_slab_exp_no_consume_from_a_decoded_state(cuda_device,
                                                            exp_draws):
    """no_consume's kernel held to its plain version from the state one
    plain full iteration leaves (from beta = 0 both are NaN throughout):
    every element finite, beta within 1e-2 of the output scale."""
    model, y_n, _ = exp_draws
    args = _slab_args(model, y_n, cuda_device)
    state = amp_slab_exp_reference("full", *args, 1, keep_state=True,
                                   order="kernel")[2]
    bk, tk = amp_slab_exp("no_consume", *args, 2, state=state)
    bp, tp = amp_slab_exp_reference("no_consume", *args, 2, state=state,
                                    order="kernel")
    assert bool(torch.isfinite(bk).all() & torch.isfinite(bp).all())
    err = (bk - bp).abs().max() / bp.abs().max()
    assert float(err) <= 1e-2, float(err)
    torch.testing.assert_close(tk, tp, rtol=1e-4, atol=0)


def test_cuda_amp_slab_exp_rejects_what_it_has_no_kernel_for(cuda_device):
    y = torch.zeros((2, 1024, 512), device=cuda_device)
    mask, sq = torch.ones((1024, 512), device=cuda_device), torch.ones(
        1024, device=cuda_device)
    for mode in ("f64m256", "compact64"):
        with pytest.raises(ValueError, match="no kernel"):
            amp_slab_exp(mode, y, mask, sq, 1.0, 9216, 2)
    with pytest.raises(ValueError, match="even"):
        amp_slab_exp("pair", y[:1], mask, sq, 1.0, 9216, 2)
    with pytest.raises(ValueError, match="compact"):
        amp_slab_exp("compact", y, mask, sq, 1.0, 9216, 2, keep_state=True)
    state = SlabState(y, y, y[:, 0, 0], y[:, 0, 0])
    with pytest.raises(ValueError, match="cannot resume"):
        amp_slab_exp("no_radix", y, mask, sq, 1.0, 9216, 2, state=state)
    with pytest.raises(ValueError, match="L = 1024"):
        amp_slab_exp("full", y[:, :256], mask[:256], sq[:256], 1.0, 9216, 2)
    with pytest.raises(TypeError):
        amp_slab_exp("full", y.double(), mask, sq, 1.0, 9216, 2)


# -------------------------------------- column signs, DCT, the BER legs

def _card_vs_cpu(op_k, op_c, device, batch=2, seed=0):
    """Ax and Ay of an operator on the card against the same operator on
    the CPU, max error over the output's max, and the card's adjointness
    normalized by |Ax| |z|."""
    gen = torch.Generator(device=device).manual_seed(seed)
    beta = torch.randn((batch, op_k.ML), generator=gen, device=device)
    z = torch.randn((batch, op_k.n), generator=gen, device=device)
    err = {}
    for name, fk, fc, x in (("Ax", op_k.Ax, op_c.Ax, beta),
                            ("Ay", op_k.Ay, op_c.Ay, z)):
        want = fc(x.cpu())
        err[name] = float((fk(x).cpu() - want).abs().max()
                          / want.abs().max())
    Ab, Az = op_k.Ax(beta).double(), op_k.Ay(z).double()
    gap = ((Ab * z.double()).sum(-1) - (beta.double() * Az).sum(-1)).abs()
    err["adjoint"] = float((gap / (Ab.norm(dim=-1)
                                   * z.double().norm(dim=-1))).max())
    return err


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["fwht_kron", "pallas"])
def test_cuda_col_signs_operator_matches_cpu(cuda_device, use_pallas):
    """PRESETS["pa_l1024"] with col_signs=True (ML = 2^19): the card's
    operator against the CPU's within 1e-4 of the output scale, on
    fwht_kron and, with use_pallas, on K5 (two fwht2 launches)."""
    from sparc_ldpc_tpu_torch.config import PRESETS
    from sparc_ldpc_tpu_torch.ops.operators import make_operator

    cfg = PRESETS["pa_l1024"].replace(col_signs=True)
    op_k = make_operator(cfg, cuda_device, use_pallas=use_pallas)
    op_c = make_operator(cfg, "cpu", use_pallas=use_pallas)
    assert op_k.mask is None and op_k.split_support is None
    launches = fwht2.launches
    err = _card_vs_cpu(op_k, op_c, cuda_device)
    assert fwht2.launches - launches == (4 if use_pallas else 0)
    assert err["Ax"] <= 1e-4 and err["Ay"] <= 1e-4, err
    assert err["adjoint"] <= 1e-6, err


def test_cuda_dct_operator_matches_cpu(cuda_device):
    """The DCT operator at fast_l4096's geometry (ML = 2^21, cuFFT) against
    the CPU's within 1e-4 of the output scale; adjoint within 1e-6."""
    from sparc_ldpc_tpu_torch.config import PRESETS
    from sparc_ldpc_tpu_torch.ops.operators import make_operator

    cfg = PRESETS["fast_l4096"].replace(op_kind="dct")
    assert cfg.ML == 1 << 21
    err = _card_vs_cpu(make_operator(cfg, cuda_device),
                       make_operator(cfg, "cpu"), cuda_device)
    assert err["Ax"] <= 1e-4 and err["Ay"] <= 1e-4, err
    assert err["adjoint"] <= 1e-6, err


def test_cuda_ber_legs_block_of_concat_small(cuda_device):
    """One block of concat_small at 3.0 dB through the leg tool: the torch
    leg on K1 and K2; the float32 control turns TF32 off itself (it is
    switched on here first) and launches no hand-written kernel."""
    from sparc_ldpc_tpu_torch.tools import ber_legs as bl

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = bl.run_leg("concat_small", "torch_control_f32", 1, 64, 64,
                         cuda_device)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert ctl["allow_tf32"] is False and ctl["launches"] == {}
    assert ctl["kernel"] == "xla" and ctl["bp_engine"] == "qc_xla"
    leg = bl.run_leg("concat_small", "torch", 1, 64, 64, cuda_device)
    assert leg["launches"]["amp_split"] > 0
    assert leg["launches"]["bp_qc_layered"] > 0
    for rec in (ctl, leg):
        assert rec["trials"] == 64 and rec["ebno_db"] == 3.0
        assert 0.0 <= rec["ber"] <= 1.0 and 0.0 <= rec["fer"] <= 1.0
        assert rec["bp_ok"] >= 0
