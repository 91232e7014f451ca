"""The library calls that chip_smoke.py times beside K3 and K5 (phases 18
and 11) as their yardsticks, `library_tile` and `library_fwht2`: dense
bf16 Hadamard factors through one torch.einsum (the default form) or two
torch.matmul, never called by the port.  On the CPU they compute the
plain versions' functions within chip_smoke.py's LIBRARY_TOL of the
output scale (they round their intermediates and results to bf16, the
plain versions do not or elsewhere)."""

import math

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

import chip_smoke
from sparc_ldpc_tpu_torch.ops.amp_kernel import fwht_tile_reference
from sparc_ldpc_tpu_torch.ops.fwht import factorize_pow2
from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2_reference


@pytest.mark.parametrize("B,L,M", [(2, 64, 128), (3, 256, 32), (1, 32, 512)])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_library_tile_is_k3s_function(B, L, M, prec):
    x = torch.randn((B, L, M), generator=torch.Generator().manual_seed(L))
    scale = 1.0 / math.sqrt(L * M / 4)
    ref = fwht_tile_reference(x, prec) * scale
    got = chip_smoke.library_tile(x, scale)
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= chip_smoke.LIBRARY_TOL, err


@pytest.mark.parametrize("logn", [11, 14, 17])
def test_library_fwht2_is_k5s_function(logn):
    x = torch.randn((3, 1 << logn), generator=torch.Generator().manual_seed(1))
    f1, f2 = factorize_pow2(1 << logn, max_log=10)
    ref = fwht2_reference(x)
    got = chip_smoke.library_fwht2(x, f1, f2)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= chip_smoke.LIBRARY_TOL, err


@pytest.mark.parametrize("B,L,M", [(2, 64, 128), (3, 256, 32), (1, 32, 512)])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_library_tile_matmul_is_k3s_function(B, L, M, prec):
    x = torch.randn((B, L, M), generator=torch.Generator().manual_seed(L))
    scale = 1.0 / math.sqrt(L * M / 4)
    ref = fwht_tile_reference(x, prec) * scale
    got = chip_smoke.library_tile(x, scale, "matmul")
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= chip_smoke.LIBRARY_TOL, err


@pytest.mark.parametrize("logn", [11, 14, 17])
def test_library_fwht2_matmul_is_k5s_function(logn):
    x = torch.randn((3, 1 << logn), generator=torch.Generator().manual_seed(1))
    f1, f2 = factorize_pow2(1 << logn, max_log=10)
    ref = fwht2_reference(x)
    got = chip_smoke.library_fwht2(x, f1, f2, "matmul")
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= chip_smoke.LIBRARY_TOL, err


def test_library_forms_agree_and_unknown_form_raises():
    """Both forms are the same products: on integer inputs every sum is
    exact in float32 and every value a small integer, so they agree bit
    for bit; an unknown form is refused."""
    x = torch.randint(-4, 5, (2, 32, 64),
                      generator=torch.Generator().manual_seed(3)).float()
    assert torch.equal(chip_smoke.library_tile(x, 1.0, "einsum"),
                       chip_smoke.library_tile(x, 1.0, "matmul"))
    with pytest.raises(ValueError, match="form"):
        chip_smoke.library_tile(x, 1.0, "dense")
