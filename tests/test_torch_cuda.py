"""The CUDA kernels (sparc_ldpc_tpu_torch/csrc/amp_split.cu and
csrc/bp_qc_layered.cu) against their plain PyTorch versions, on an NVIDIA
GPU.

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
bitwise equal to its plain version.
"""

import math

import numpy as np
import pytest
import torch

from sparc_ldpc_tpu.config import ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu.design.ldpc_codes import build_code, qc_structure
from sparc_ldpc_tpu_torch.models.amp import decision_flips
from sparc_ldpc_tpu_torch.models.concat import ConcatModel
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, fwht_tile, fwht_tile_reference)
from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
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


@pytest.mark.parametrize("L,M", [(64, 128), (256, 512), (1024, 512)])
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
    bk, tk, ik = amp_fused(*args, encode_idx=idx, precision="highest")
    assert amp_fused.launches == launches + 1
    bp, tp, ip = amp_fused_reference(*args, encode_idx=idx,
                                     precision="highest")
    assert torch.equal(ik.cpu(), ip.cpu())
    flips, decisive = decision_flips(bp, bk)
    assert decisive == 0 and flips <= 0.01 * idx.numel()
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=1e-4)
    assert float((bk - bp).abs().max()) <= 1e-3
    bk, tk, _ = amp_fused(*args, encode_idx=idx)
    bp, tp, _ = amp_fused_reference(*args, encode_idx=idx)
    assert decision_flips(bp, bk)[1] == 0
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=2e-2)
    # without encode_idx, y_n is the whole observation: only masked
    bk, tk, _ = amp_fused(*args, precision="highest")
    bp, tp, _ = amp_fused_reference(*args, precision="highest")
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=1e-4)
    assert float((bk - bp).abs().max()) <= 1e-3


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
    kw = dict(encode_idx=idx, precision="highest")
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


@pytest.mark.parametrize("method", ["minsum", "oms"])
@pytest.mark.parametrize("code", [31, "wifi_n648_r12", "qc_n648_r56",
                                  "wifi_n1296_r12", "wifi_n1944_r12"])
def test_cuda_bp_kernel_bitwise_matches_plain(cuda_device, code, method):
    """K2 against the plain layered engine, bitwise, for Z = 31, 27, 54
    and 81: hard decisions, ok flags, iteration counts, posteriors."""
    # rate 1/2 codes at sigma 0.75, the rate ~0.84 codes at 0.5: a mix of
    # frames that decode early and frames that run all 20 iterations
    sigma = 0.75 if "r12" in str(code) else 0.5
    shifts, Z, llr = _qc_llrs(code, 300, sigma, cuda_device)
    launches = bp_decode_qc_kernel.launches
    rk = bp_decode_qc_kernel(llr, shifts, Z, iters=20, method=method)
    assert bp_decode_qc_kernel.launches == launches + 1
    rp = bp_decode_qc(llr, QcBpTables.build(np.asarray(shifts), Z,
                                            device=cuda_device),
                      iters=20, method=method, schedule="layered")
    for f in ("hard", "ok", "iters", "posterior"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f
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
