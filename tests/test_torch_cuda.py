"""The CUDA kernel (sparc_ldpc_tpu_torch/csrc/amp_split.cu) against its
plain PyTorch version, on an NVIDIA GPU.

Every test here is marked `cuda` and skips where no GPU is visible.  The
file imports no JAX, so it also runs where the JAX reference is not
installed; there the suite's conftest (which imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: in float32 the kernel and the plain version differ only in
summation order (tau2 to rtol 1e-4, beta to 1e-3, decisions
margin-aware); with bf16 operand rounding they agree in distribution
(tau2 to rtol 2e-2, no decisive flips at these well-decoding points).
"""

import math

import numpy as np
import pytest
import torch

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu_torch.models.amp import decision_flips
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, fwht_tile, fwht_tile_reference)
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
    bk, tk = amp_fused(*args, encode_idx=idx, precision="highest")
    assert amp_fused.launches == launches + 1
    bp, tp = amp_fused_reference(*args, encode_idx=idx, precision="highest")
    flips, decisive = decision_flips(bp, bk)
    assert decisive == 0 and flips <= 0.01 * idx.numel()
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=1e-4)
    assert float((bk - bp).abs().max()) <= 1e-3
    bk, tk = amp_fused(*args, encode_idx=idx)
    bp, tp = amp_fused_reference(*args, encode_idx=idx)
    assert decision_flips(bp, bk)[1] == 0
    np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(), rtol=2e-2)
    # without encode_idx, y_n is the whole observation: only masked
    bk, tk = amp_fused(*args, precision="highest")
    bp, tp = amp_fused_reference(*args, precision="highest")
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
