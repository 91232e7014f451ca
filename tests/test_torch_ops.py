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

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.design.codebook import hadamard_plan
from sparc_ldpc_tpu.ops import denoiser as jden
from sparc_ldpc_tpu.ops import fwht as jfwht
from sparc_ldpc_tpu.ops import operators as jops
from sparc_ldpc_tpu.oracle.fwht import fwht_np
from sparc_ldpc_tpu.utils import bits as jbits

from sparc_ldpc_tpu_torch.ops import denoiser as tden
from sparc_ldpc_tpu_torch.ops import fwht as tfwht
from sparc_ldpc_tpu_torch.ops import operators as tops
from sparc_ldpc_tpu_torch.ops.amp_kernel import fwht_tile, fwht_tile_reference
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
