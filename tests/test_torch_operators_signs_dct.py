"""The port's column-signed Hadamard operator (col_signs=True) and its DCT
operator (op_kind="dct") against the JAX reference on the CPU.

The same NumPy inputs go through the reference's `make_operator` and the
port's: Ax, Ay and, for the Hadamard operator, the N-space members, at
float32 tolerance (rtol and atol 1e-4); the --pallas pair against the
reference's `fwht_pallas` in interpret mode; the DCT against the float64
oracle operator, as the reference's tests/test_ops.py holds its own;
adjointness as tests/test_ops.py and, at L=4096, tests/test_big_config.py
hold it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import SparcConfig as JSparcConfig
from sparc_ldpc_tpu.design.codebook import hadamard_plan
from sparc_ldpc_tpu.ops import fwht as jfwht
from sparc_ldpc_tpu.ops import operators as jops
from sparc_ldpc_tpu.oracle import sparc as osparc

from sparc_ldpc_tpu_torch.config import SparcConfig
from sparc_ldpc_tpu_torch.ops import operators as tops
from sparc_ldpc_tpu_torch.ops.dct import dct2_ortho, dct3_ortho

TOL = dict(rtol=1e-4, atol=1e-4)
GEOMETRIES = [dict(L=32, M=64, R=1.0), dict(L=64, M=128, R=1.2)]
KINDS = {"col_signs": dict(op_kind="hadamard", col_signs=True,
                           transform_precision="highest"),
         "dct": dict(op_kind="dct")}


def _cfgs(kind, geometry):
    kw = dict(geometry, **KINDS[kind])
    return SparcConfig(**kw), JSparcConfig(**kw)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N", [2, 8, 1024, 1 << 13])
def test_dct_pair_matches_scipy(N):
    """dct2_ortho and dct3_ortho are scipy's DCT-II and DCT-III with
    norm="ortho", and each inverts the other."""
    x = np.random.default_rng(N).standard_normal((3, N))
    want = scipy.fft.dct(x, norm="ortho", axis=-1)
    got = dct2_ortho(torch.tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
    back = dct3_ortho(torch.tensor(want, dtype=torch.float32))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())
    np.testing.assert_allclose(
        dct3_ortho(torch.tensor(x, dtype=torch.float32)).numpy(),
        scipy.fft.idct(x, norm="ortho", axis=-1), rtol=1e-5,
        atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"L{g['L']}M{g['M']}R{g['R']}")
def test_operator_matches_jax(kind, geometry):
    cfg, jcfg = _cfgs(kind, geometry)
    op_t, op_j = tops.make_operator(cfg), jops.make_operator(jcfg)
    assert (op_t.n, op_t.ML, op_t.N) == (op_j.n, op_j.ML, op_j.N)
    # no mask, no split tables: a fused config takes the scan route
    assert op_t.mask is None and op_j.mask is None
    assert op_t.split_support is None
    rng = np.random.default_rng(7)
    beta = rng.standard_normal((3, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((3, cfg.n)).astype(np.float32)
    _close(op_t.Ax(_t(beta)), op_j.Ax(jnp.asarray(beta)))
    _close(op_t.Ay(_t(z)), op_j.Ay(jnp.asarray(z)))
    if kind == "dct":
        assert op_t.resid_n is None and op_j.resid_n is None
        return
    zN = rng.standard_normal((3, op_t.N)).astype(np.float32)
    coef = rng.standard_normal((3, 1)).astype(np.float32)
    _close(op_t.adj_n(_t(zN)), op_j.adj_n(jnp.asarray(zN)))
    _close(op_t.resid_n(_t(zN), _t(beta), _t(zN), _t(coef)),
           op_j.resid_n(jnp.asarray(zN), jnp.asarray(beta), jnp.asarray(zN),
                        jnp.asarray(coef)))
    np.testing.assert_array_equal(op_t.embed_y(_t(z)).numpy(),
                                  np.asarray(op_j.embed_y(jnp.asarray(z))))


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"L{g['L']}M{g['M']}R{g['R']}")
def test_signed_pallas_pair_matches_jax_fwht_pallas(geometry, monkeypatch):
    """The --pallas operator with column signs (fwht2, here its plain
    version) against the reference's, whose fwht_pallas runs in interpret
    mode."""
    cfg, jcfg = _cfgs("col_signs", geometry)
    monkeypatch.setattr(jops, "fwht_pallas",
                        functools.partial(jfwht.fwht_pallas, interpret=True))
    op_t = tops.make_operator(cfg, use_pallas=True)
    op_j = jops.make_operator(jcfg, use_pallas=True)
    assert op_t.mask is None and op_t.resid_n is None
    rng = np.random.default_rng(8)
    beta = rng.standard_normal((2, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((2, cfg.n)).astype(np.float32)
    _close(op_t.Ax(_t(beta)), op_j.Ax(jnp.asarray(beta)))
    _close(op_t.Ay(_t(z)), op_j.Ay(jnp.asarray(z)))


def test_signs_change_the_operator():
    """The signs are applied: with them Ax differs from the unsigned
    operator's on the same rows, and equals it on the signed input."""
    cfg = SparcConfig(L=32, M=64, R=1.0, col_signs=True,
                      transform_precision="highest")
    signed = tops.make_operator(cfg)
    plain = tops.make_operator(cfg.replace(col_signs=False))
    signs = torch.tensor(hadamard_plan(cfg.n, cfg.ML, cfg.op_seed,
                                       True).signs, dtype=torch.float32)
    beta = torch.randn(2, cfg.ML, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(signed.Ax(beta), plain.Ax(beta))
    torch.testing.assert_close(signed.Ax(beta), plain.Ax(beta * signs))
    z = torch.randn(2, cfg.n, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(signed.Ay(z), plain.Ay(z) * signs)


def test_dct_operator_matches_float64_oracle():
    """As tests/test_ops.py holds the reference's DCT operator."""
    cfg = SparcConfig(L=32, M=64, R=1.0, op_kind="dct")
    op = tops.make_operator(cfg)
    oop = osparc.make_operator(JSparcConfig(L=32, M=64, R=1.0,
                                            op_kind="dct"))
    rng = np.random.default_rng(9)
    beta = rng.standard_normal((3, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((3, cfg.n)).astype(np.float32)
    fwd_o = np.stack([oop.Ax(b.astype(np.float64)) for b in beta])
    adj_o = np.stack([oop.Ay(v.astype(np.float64)) for v in z])
    np.testing.assert_allclose(op.Ax(_t(beta)).numpy(), fwd_o, **TOL)
    np.testing.assert_allclose(op.Ay(_t(z)).numpy(), adj_o, **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_operator_is_adjoint(kind):
    """<Ax, z> == <x, A^T z>, at the reference's tests/test_ops.py
    tolerance and configuration."""
    cfg, _ = _cfgs(kind, dict(L=64, M=128, R=1.2))
    op = tops.make_operator(cfg)
    rng = np.random.default_rng(10)
    beta = _t(rng.standard_normal((2, cfg.ML)).astype(np.float32))
    z = _t(rng.standard_normal((2, cfg.n)).astype(np.float32))
    lhs = (op.Ax(beta) * z).sum(-1)
    rhs = (beta * op.Ay(z)).sum(-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=2e-3,
                               atol=1e-2)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_l4096_operator_is_adjoint(kind):
    """At ML = 2^21 (judged configuration 3), normalized by ||Ax|| ||z||,
    within tests/test_big_config.py's 1e-7."""
    cfg = SparcConfig(L=4096, M=512, R=1.5, power_alloc="iterative",
                      **KINDS[kind])
    assert cfg.ML == 1 << 21
    op = tops.make_operator(cfg)
    rng = np.random.default_rng(11)
    beta = _t(rng.standard_normal((1, cfg.ML)).astype(np.float32))
    z = _t(rng.standard_normal((1, cfg.n)).astype(np.float32))
    Ab, Az = op.Ax(beta), op.Ay(z)
    lhs = float((Ab.double() * z.double()).sum())
    rhs = float((beta.double() * Az.double()).sum())
    scale = float(Ab.double().norm() * z.double().norm())
    assert abs(lhs - rhs) < 1e-7 * scale, (lhs, rhs, scale)
