"""The PyTorch port's ops against the JAX reference on the CPU.

Same NumPy inputs, made from a seed, go through the JAX function and its
counterpart in sparc_ldpc_tpu_torch; each test applies the reference's own
contract: exact for bit packing and operator plans, float64-oracle and
JAX-parity tolerances for the transforms and the denoiser.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.design.codebook import hadamard_plan
from sparc_ldpc_tpu.ops import amp_kernel as jamp
from sparc_ldpc_tpu.ops import denoiser as jden
from sparc_ldpc_tpu.ops import fwht as jfwht
from sparc_ldpc_tpu.ops import operators as jops
from sparc_ldpc_tpu.oracle.fwht import fwht_np
from sparc_ldpc_tpu.utils import bits as jbits

from sparc_ldpc_tpu_torch.ops import amp_kernel as tamp
from sparc_ldpc_tpu_torch.ops import denoiser as tden
from sparc_ldpc_tpu_torch.ops import fwht as tfwht
from sparc_ldpc_tpu_torch.ops import fwht_kernel as tfk
from sparc_ldpc_tpu_torch.ops import operators as tops
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    K3_CLUSTER_ROWS, fwht_tile, fwht_tile_reference, k3_design)
from sparc_ldpc_tpu_torch.ops.split_support import split_geometry
from sparc_ldpc_tpu_torch.utils import bits as tbits
from sparc_ldpc_tpu_torch.utils.rng import block_generator, block_seed


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------------ utils

@pytest.mark.parametrize("logM", [1, 4, 9])
def test_bits_indices_match_jax_exactly(logM):
    rng = np.random.default_rng(logM)
    bits = rng.integers(0, 2, (3, 16 * logM)).astype(np.int32)
    idx_j = np.asarray(jbits.bits_to_indices(jnp.asarray(bits), logM))
    idx_t = tbits.bits_to_indices(_t(bits), logM)
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    back_j = np.asarray(jbits.indices_to_bits(jnp.asarray(idx_j), logM))
    back_t = tbits.indices_to_bits(idx_t, logM)
    np.testing.assert_array_equal(back_t.numpy(), back_j)
    np.testing.assert_array_equal(back_t.numpy(), bits)


def test_block_generator_is_a_function_of_its_coordinates():
    def draw(*coords):
        return torch.randn(64, generator=block_generator(*coords))

    assert torch.equal(draw(1, 2, 3), draw(1, 2, 3))
    assert not torch.equal(draw(1, 2, 3), draw(1, 2, 4))
    assert not torch.equal(draw(1, 2, 3), draw(1, 3, 3))
    assert block_seed(1, 2, 3) != block_seed(2, 1, 3)
    assert 0 <= block_seed(7, 0, 0) < 2 ** 64


# --------------------------------------------------------------- transform

@pytest.mark.parametrize("N", [1, 2, 512, 1 << 13, 1 << 19, 1 << 21])
def test_factorize_pow2_matches_jax(N):
    assert tfwht.factorize_pow2(N) == jfwht.factorize_pow2(N)


@pytest.mark.parametrize("f", [1, 2, 16, 128])
def test_hadamard_factor_matches_jax(f):
    np.testing.assert_array_equal(tfwht.hadamard_factor(f).numpy(),
                                  np.asarray(jfwht.hadamard_factor(f)))


@pytest.mark.parametrize("N", [1 << 10, 1 << 14])
def test_fwht_kron_f32_matches_float64_oracle(N):
    x = np.random.default_rng(N).standard_normal((2, N)).astype(np.float32)
    want = fwht_np(x.astype(np.float64))
    got = tfwht.fwht_kron(_t(x), "highest").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tfwht.fwht_butterfly(_t(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_fwht_kron_bf16_matches_jax_fwht_mxu():
    """bf16 rounds the data operand before each factor, as fwht_mxu does;
    both stay within the reference's 5e-3 bf16 budget of the truth."""
    N = 1 << 14
    x = np.random.default_rng(0).standard_normal((2, N)).astype(np.float32)
    want = fwht_np(x.astype(np.float64))
    got = tfwht.fwht_kron(_t(x), "bf16").numpy()
    ref = np.asarray(jfwht.fwht_mxu(jnp.asarray(x), precision="bf16"))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-3


@pytest.mark.parametrize("L,M", [(64, 128), (256, 64)])
def test_fwht_tile_is_the_flattened_transform(L, M):
    x = np.random.default_rng(L).standard_normal((2, L, M)).astype(np.float32)
    want = fwht_np(x.reshape(2, L * M).astype(np.float64)).reshape(2, L, M)
    got = fwht_tile_reference(_t(x), "highest").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the wrapper runs the plain version on CPU tensors, without a launch
    launches = fwht_tile.launches
    np.testing.assert_array_equal(fwht_tile(_t(x)).numpy(),
                                  fwht_tile_reference(_t(x)).numpy())
    assert fwht_tile.launches == launches


@pytest.mark.parametrize("L", [1 << k for k in range(5, 13)])
def test_k3_design_for_every_tile_height(L):
    """K3's path on the card for every l in [32, 4096]: in bf16 the one
    launch on a cluster of M / 32 blocks a codeword (at most 16, the
    largest cluster an H100 schedules) up to K3_CLUSTER_ROWS rows and
    M <= 512, the row and column launches above (their column launch on
    the column geometry's clusters of L / 1024 blocks); float32 keeps the
    earlier stages."""
    for M in (32, 64, 128, 256, 512, 1024):
        design = k3_design(L, M, "bf16")
        if design == "cluster":
            assert L <= K3_CLUSTER_ROWS == 256 and 1 <= M // 32 <= 16
            assert L * 192 <= 227 * 1024      # its shared memory a block
        else:
            assert design == "rows_cols" and (L > 256 or M == 1024)
            W, R, FA = split_geometry(L)
            assert FA == max(1, L // 1024) and W * R * FA == L
        for prec in ("highest", "high", "default"):
            assert k3_design(L, M, prec) == "float32"


@pytest.mark.parametrize("N", [1 << 13, 1 << 15])
def test_fwht2_route_matches_jax_fwht_pallas(N):
    """K5: the port's fwht2 (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, to the reference's own
    tolerance (tests/test_ops.py:46)."""
    x = np.random.default_rng(N).standard_normal((3, N)).astype(np.float32)
    want = np.asarray(jfwht.fwht_pallas(jnp.asarray(x), interpret=True))
    launches = tfk.fwht2.launches
    got = tfk.fwht2(_t(x)).numpy()
    assert tfk.fwht2.launches == launches
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3 * math.sqrt(N))
    np.testing.assert_allclose(got, fwht_np(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-5 * math.sqrt(N) * 4)


@pytest.mark.parametrize("N", [1 << 13, 1 << 15])
def test_fwht2_bf16_rounds_only_the_input_like_fwht_pallas(N):
    x = np.random.default_rng(N + 1).standard_normal((2, N)).astype(np.float32)
    want = np.asarray(jfwht.fwht_pallas(jnp.asarray(x), interpret=True,
                                        bf16=True))
    got = tfk.fwht2(_t(x), bf16=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3 * math.sqrt(N))
    exact = fwht_np(tfwht.round_bf16(_t(x)).numpy().astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-5,
                               atol=1e-5 * np.abs(exact).max())


@pytest.mark.parametrize("N", [1 << 10, 1 << 21])
def test_fwht2_routes_to_fwht_kron_where_fwht_pallas_falls_back(N):
    """One factor (N <= 2^10) or three (N > 2^20): the reference's
    fwht_mxu rule."""
    assert len(tfwht.factorize_pow2(N, max_log=10)) != 2
    x = torch.randn((1, N), generator=torch.Generator().manual_seed(N))
    assert torch.equal(tfk.fwht2(x), tfwht.fwht_kron(x, "high"))


# ------------------------------------------------------------------- noise

def _philox_py(ctr, key):
    """Philox4x32-10 in Python integers, as Random123 defines it."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF,
                 (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & 0xFFFFFFFF, p1 & 0xFFFFFFFF,
             ((p0 >> 32) ^ c[3] ^ k[1]) & 0xFFFFFFFF, p0 & 0xFFFFFFFF]
    return c


# Random123's known-answer vectors: counter, key -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_matches_known_answers(ctr, key, want):
    assert tuple(_philox_py(ctr, key)) == want
    got = tamp.philox4x32(tuple(torch.tensor(c) for c in ctr),
                          tuple(torch.tensor(k) for k in key))
    assert tuple(int(w) for w in got) == want


def test_philox_matches_python_philox_on_random_words():
    rng = np.random.default_rng(9)
    ctr = rng.integers(0, 2 ** 32, (4, 64), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64)
    got = tamp.philox4x32(tuple(torch.tensor(c.astype(np.int64)) for c in ctr),
                          tuple(torch.tensor(k.astype(np.int64)) for k in key))
    got = np.stack([w.numpy() for w in got])
    want = np.array([_philox_py([int(c) for c in ctr[:, i]],
                                [int(k) for k in key[:, i]])
                     for i in range(64)]).T
    np.testing.assert_array_equal(got, want)


def test_box_muller_matches_jax_on_the_same_bits():
    rng = np.random.default_rng(10)
    b1, b2 = (rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
              for _ in range(2))
    b1[:2] = (0, 0xFFFFFFFF)                      # the u1 floor and top
    zc_j, zs_j = jamp.boxmuller_pair_f32(jnp.asarray(b1.astype(np.uint32)),
                                         jnp.asarray(b2.astype(np.uint32)))
    zc_t, zs_t = tamp.box_muller(torch.tensor(b1.astype(np.int64)),
                                 torch.tensor(b2.astype(np.int64)))
    np.testing.assert_allclose(zc_t.numpy(), np.asarray(zc_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), rtol=1e-6,
                               atol=1e-6)


def test_channel_noise_is_masked_gaussian_and_a_function_of_the_seed():
    L, M, B = 64, 128, 32
    mask = torch.zeros((L, M))
    mask.view(-1)[torch.randperm(L * M, generator=torch.Generator()
                                 .manual_seed(0))[:L * M // 2]] = 1.0
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    launches = tamp.channel_noise.launches
    z = tamp.channel_noise(seeds, mask, 0.5)
    assert tamp.channel_noise.launches == launches
    assert torch.equal(z, tamp.channel_noise_reference(seeds, mask, 0.5))
    assert bool((z[:, mask == 0] == 0).all())
    on = z[:, mask > 0].double()
    count = on.numel()
    assert abs(float(on.mean())) < 4 * 0.5 / math.sqrt(count)
    assert abs(float(on.var()) / 0.25 - 1) < 0.03
    other = seeds.clone()
    other[0, 1] ^= 1
    z2 = tamp.channel_noise_reference(other, mask, 0.5)
    assert torch.equal(z2[1:], z[1:]) and not torch.equal(z2[0], z[0])
    u1, theta = tamp.noise_uniforms(seeds, L, M)
    assert float(u1.min()) > 0 and float(u1.max()) < 1
    assert float(theta.min()) >= 0 and float(theta.max()) < 2 * math.pi


# --------------------------------------------------------------- operators

CFG = SparcConfig(L=64, M=128, R=1.0, op_kind="hadamard",
                  transform_precision="highest")


def test_hadamard_operator_constants_match_jax_exactly():
    op_t = tops.hadamard_operator(CFG)
    op_j = jops.hadamard_operator(CFG)
    plan = hadamard_plan(CFG.n, CFG.ML, CFG.op_seed)
    assert (op_t.n, op_t.ML, op_t.N) == (op_j.n, op_j.ML, op_j.N)
    np.testing.assert_array_equal(op_t.mask.numpy(), np.asarray(op_j.mask))
    np.testing.assert_array_equal(np.flatnonzero(op_t.mask.numpy()),
                                  plan.rows)


def test_hadamard_operator_is_adjoint():
    op = tops.hadamard_operator(CFG)
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((3, CFG.ML)).astype(np.float32))
    z = _t(rng.standard_normal((3, CFG.n)).astype(np.float32))
    lhs = (op.Ax(x) * z).sum(-1).double()
    rhs = (x * op.Ay(z)).sum(-1).double()
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_hadamard_operator_matches_jax(precision):
    cfg = CFG.replace(transform_precision=precision)
    op_t, op_j = tops.hadamard_operator(cfg), jops.hadamard_operator(cfg)
    rng = np.random.default_rng(2)
    beta = rng.standard_normal((2, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((2, cfg.n)).astype(np.float32)
    zN = rng.standard_normal((2, op_t.N)).astype(np.float32)
    coef = rng.standard_normal((2, 1)).astype(np.float32)
    rtol = 1e-5 if precision == "highest" else 5e-3

    def close(got, want):
        got, want = got.numpy(), np.asarray(want)
        if precision == "highest":
            np.testing.assert_allclose(got, want, rtol=rtol,
                                       atol=rtol * np.abs(want).max())
        else:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err < rtol, err

    close(op_t.Ax(_t(beta)), op_j.Ax(jnp.asarray(beta)))
    close(op_t.Ay(_t(z)), op_j.Ay(jnp.asarray(z)))
    close(op_t.adj_n(_t(zN)), op_j.adj_n(jnp.asarray(zN)))
    close(op_t.resid_n(_t(zN), _t(beta), _t(zN), _t(coef)),
          op_j.resid_n(jnp.asarray(zN), jnp.asarray(beta), jnp.asarray(zN),
                       jnp.asarray(coef)))
    np.testing.assert_array_equal(op_t.embed_y(_t(z)).numpy(),
                                  np.asarray(op_j.embed_y(jnp.asarray(z))))


def test_dense_operator_matches_jax():
    cfg = SparcConfig(L=16, M=16, R=1.0, op_kind="dense")
    op_t, op_j = tops.dense_operator(cfg), jops.dense_operator(cfg)
    rng = np.random.default_rng(3)
    beta = rng.standard_normal((2, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((2, cfg.n)).astype(np.float32)
    np.testing.assert_allclose(op_t.Ax(_t(beta)).numpy(),
                               np.asarray(op_j.Ax(jnp.asarray(beta))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(op_t.Ay(_t(z)).numpy(),
                               np.asarray(op_j.Ay(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- denoiser

@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_denoise_matches_jax(scale):
    """scale=30 drives the softmax argument far past exp's f32 range
    without the max subtraction."""
    rng = np.random.default_rng(4)
    B, L, M = 2, 8, 64
    s = (scale * rng.standard_normal((B, L, M))).astype(np.float32)
    tau2 = rng.uniform(0.05, 1.0, B).astype(np.float32)
    sq = rng.uniform(1.0, 3.0, L).astype(np.float32)
    bt, pt = tden.denoise(_t(s), _t(tau2), _t(sq))
    bj, pj = jden.denoise(jnp.asarray(s), jnp.asarray(tau2), jnp.asarray(sq))
    assert torch.isfinite(bt).all()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-6 * math.sqrt(M))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-7)


def test_denoise_kernel_route_matches_jax_denoise_pallas():
    """K4: the port's denoise_kernel (its plain version on the CPU) against
    the reference's Pallas kernel in interpret mode, to the reference's own
    tolerance (tests/test_ops.py:104-107)."""
    rng = np.random.default_rng(11)
    B, L, M = 2, 32, 128
    s = rng.standard_normal((B, L, M)).astype(np.float32)
    tau2 = np.array([0.7, 0.2], dtype=np.float32)
    sq = np.sqrt(100 * np.full(L, 1.0 / L)).astype(np.float32)
    bj, pj = jden.denoise_pallas(jnp.asarray(s), jnp.asarray(tau2),
                                 jnp.asarray(sq), l_tile=16, interpret=True)
    launches = tden.denoise_kernel.launches
    bt, pt = tden.denoise_kernel(_t(s), _t(tau2), _t(sq))
    assert tden.denoise_kernel.launches == launches
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-7)
