"""The port's concatenated SPARC + LDPC chain against the JAX reference on
the CPU, at a small geometry: L = M = 64, the z = 13 3 x 12 array code
(n = 156, one codeword per frame, 26 protected sections), layered min-sum.

Both packages get the same NumPy draws.  Contracts: exact for the
partition, the section indices and the LDPC encode; the LLR fold to atol
2e-4 / rtol 1e-3 (float32 reassociation, the reference's own bound); for
the whole chain at a point where BP decodes, identical codewords, ok flags
and user bits, with the AMP decisions margin-aware (bf16 transforms) and
the AMP iteration counts within 4 per frame (the reference's rule for the
early stop, tests/test_precision.py:448-449).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import PRESETS, ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu.models.concat import ConcatModel as JConcat
from sparc_ldpc_tpu.models.concat import _derive_partition as j_partition
from test_precision import assert_decisions_match

from sparc_ldpc_tpu_torch.models.concat import ConcatModel, _derive_partition
from sparc_ldpc_tpu_torch.models.ldpc import LdpcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
from sparc_ldpc_tpu_torch.utils.rng import block_generator

EBNO = 4.0
SMALL = ConcatConfig(
    sparc=SparcConfig(L=64, M=64, R=1.0, power_alloc="iterative",
                      op_kind="hadamard", amp_kernel="fused_split",
                      amp_tol=1e-4, transform_precision="bf16", amp_iters=16),
    ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12, engine="qc",
                    schedule="layered", bp_iters=16),
    f_prot=0.5)
# the scan route with the encode outside the decoder, in float32
SMALL_XLA = SMALL.replace(sparc=SMALL.sparc.replace(
    amp_kernel="xla", transform_precision="highest"))


def _draws(model, B, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, model.k_user)).astype(np.int32)
    noise = rng.standard_normal((B, model.sparc.cfg.n)).astype(np.float32)
    return bits, noise


def _counters(bits, user_hat):
    be = (np.asarray(bits) != np.asarray(user_hat)).sum(-1)
    return dict(bit_errors=int(be.sum()), frame_errors=int((be > 0).sum()),
                bit_errors_sq=float((be.astype(np.float64) ** 2).sum()))


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("preset,user_bits", [
    ("concat", 8490), ("concat_wifi", 8244), ("concat_r56", 8892)])
def test_partition_matches_jax_on_the_presets(preset, user_bits):
    cfg = PRESETS[preset]
    ldpc = LdpcModel.build(cfg.ldpc, "cpu")
    args = (cfg.sparc.L, cfg.sparc.logM, ldpc.n, cfg.f_prot)
    Lu, Lp, num_cw = _derive_partition(*args)
    assert (Lu, Lp, num_cw) == j_partition(*args)
    assert num_cw * ldpc.n == Lp * cfg.sparc.logM
    assert Lu * cfg.sparc.logM + num_cw * ldpc.k == user_bits
    with pytest.raises(ValueError):
        _derive_partition(64, 6, 1000, 0.5)


def test_small_model_matches_jax():
    mj = JConcat.build(SMALL, EBNO)
    mt = ConcatModel.build(SMALL, EBNO, "cpu")
    assert (mt.Lu, mt.Lp, mt.num_cw) == (mj.Lu, mj.Lp, mj.num_cw) \
        == (38, 26, 1)
    assert mt.k_user == mj.k_user and mt.overall_rate == mj.overall_rate
    assert mt.sparc.cfg == mj.sparc.cfg
    np.testing.assert_array_equal(mt.sparc.sq_npl.numpy(),
                                  np.asarray(mj.sparc.sq_npl))
    bits, _ = _draws(mt, 4)
    np.testing.assert_array_equal(
        mt._true_indices(torch.tensor(bits)).numpy(),
        np.asarray(mj._true_indices(jnp.asarray(bits))))
    xj = np.asarray(mj.encode(jnp.asarray(bits)))
    np.testing.assert_allclose(mt.encode(torch.tensor(bits)).numpy(), xj,
                               rtol=1e-2, atol=1e-2 * np.abs(xj).max())


# ------------------------------------------------------------- LLR fold

def test_llr_fold_matches_jax_with_zero_and_subnormal_bit_sets():
    mj = JConcat.build(SMALL, EBNO)
    mt = ConcatModel.build(SMALL, EBNO, "cpu")
    L, M, logM = 64, 64, 6
    rng = np.random.default_rng(9)
    beta = (rng.random((3, L, M)) ** 8).astype(np.float32)
    bit = (np.arange(M)[None, :] >> (logM - 1 - np.arange(logM)[:, None])) & 1
    r0, r1 = mt.Lu + 2, mt.Lu + 5
    beta[0, r0, bit[1] == 1] = 0.0           # a bit-set with no mass
    beta[1, r1, bit[4] == 1] = 0.0
    beta[1, r1, np.flatnonzero(bit[4] == 1)[3]] = 1e-40  # subnormal mass
    assert 0 < beta[1, r1, bit[4] == 1].sum() < np.finfo(np.float32).tiny
    lj = np.asarray(mj._protected_llrs_from_beta(jnp.asarray(beta)))
    lt = mt._protected_llrs_from_beta(torch.tensor(beta)).numpy()
    np.testing.assert_allclose(lt, lj, atol=2e-4, rtol=1e-3)
    floor = np.log(np.finfo(np.float32).tiny)
    for b, r, k in ((0, r0, 1), (1, r1, 4)):
        i = (r - mt.Lu) * logM + k
        assert np.isfinite(lt[b, i]) and lt[b, i] > 0
        np.testing.assert_allclose(lt[b, i], np.log(beta[b, r][bit[k] == 0]
                                                    .sum()) - floor,
                                   rtol=1e-5)
    scores = np.log(np.maximum(beta / np.asarray(mj.sparc.sq_npl)[None, :,
                                                                 None],
                               np.finfo(np.float32).tiny))
    np.testing.assert_allclose(
        mt._protected_llrs(torch.tensor(scores)).numpy(),
        np.asarray(mj._protected_llrs(jnp.asarray(scores))),
        atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------- whole chain

def test_in_kernel_encode_chain_matches_jax():
    """run_block_from on the in-kernel-encode branch against the JAX chain
    built from its own methods on the same draws."""
    mj = JConcat.build(SMALL, EBNO)
    mt = ConcatModel.build(SMALL, EBNO, "cpu")
    bits, noise = _draws(mt, 6)
    y = noise * np.float32(math.sqrt(mj.sparc.sigma2))
    idx_j = mj._true_indices(jnp.asarray(bits))
    res_j = mj.sparc.decode(jnp.asarray(y), encode_idx=idx_j)
    cw_j, ok_j, _ = mj._bp_from_beta(res_j.beta)
    user_j = mj._feedback_user_bits(jnp.asarray(y), cw_j, ok_j,
                                    enc_idx=idx_j)

    yt, idx_t = torch.tensor(y), mt._true_indices(torch.tensor(bits))
    res_t = mt.sparc.decode(yt, encode_idx=idx_t)
    assert_decisions_match(np.asarray(res_j.beta), res_t.beta.numpy())
    it_t, it_j = res_t.iters.numpy(), np.asarray(res_j.iters)
    assert int(np.max(np.abs(it_t - it_j))) <= 4 and it_t.min() < 16
    cw_t, ok_t, _ = mt._bp_from_beta(res_t.beta)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(cw_t.numpy(), np.asarray(cw_j))
    assert ok_t.all(), "the test point must decode"
    user_t = mt._feedback_user_bits(yt, cw_t, ok_t, enc_idx=idx_t)
    np.testing.assert_array_equal(user_t.numpy(), np.asarray(user_j))

    launches = (amp_fused.launches, bp_decode_qc_kernel.launches)
    out = {k: v.item() for k, v in mt.run_block_from(bits, noise).items()}
    assert (amp_fused.launches, bp_decode_qc_kernel.launches) == launches
    assert {k: out[k] for k in ("bit_errors", "frame_errors",
                                "bit_errors_sq")} == _counters(bits, user_j)
    assert out["trials"] == 6 and out["bp_ok"] == 6
    assert out["iters_sum"] == int(it_t.sum())
    assert abs(out["iters_sum"] - int(it_j.sum())) <= 4 * 6


def test_xla_encode_chain_matches_jax_exactly():
    """The XLA-encode branch (scan AMP in float32): identical codewords,
    ok flags, user bits and counters."""
    mj = JConcat.build(SMALL_XLA, EBNO)
    mt = ConcatModel.build(SMALL_XLA, EBNO, "cpu")
    bits, noise = _draws(mt, 6, seed=1)
    y = np.asarray(mj.encode(jnp.asarray(bits))) \
        + noise * np.float32(math.sqrt(mj.sparc.sigma2))
    dj = mj.decode(jnp.asarray(y))
    dt = mt.decode(torch.tensor(y))
    for k in ("user_bits", "bp_ok", "amp_iters", "bp_iters"):
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(dt["tau2_final"].numpy(),
                               np.asarray(dj["tau2_final"]), rtol=1e-4)
    assert dt["bp_ok"].all()
    out = {k: v.item() for k, v in mt.run_block_from(bits, noise).items()}
    assert {k: out[k] for k in ("bit_errors", "frame_errors",
                                "bit_errors_sq")} \
        == _counters(bits, dj["user_bits"])
    assert out["iters_sum"] == int(np.asarray(dj["amp_iters"]).sum())
    assert out["bp_ok"] == 6 and out["trials"] == 6


def test_from_numpy_takes_the_reference_constants():
    mj = JConcat.build(SMALL, EBNO)
    mask = np.asarray(mj.sparc.op.mask)
    params = dict(p_alloc=np.asarray(mj.sparc.p_alloc),
                  sq_npl=np.asarray(mj.sparc.sq_npl),
                  rows=np.flatnonzero(mask), mask=mask,
                  sigma2=mj.sparc.sigma2,
                  amp_iters=mj.sparc.cfg.amp_iters)
    mt = ConcatModel.from_numpy(SMALL, EBNO, params, "cpu")
    mb = ConcatModel.build(SMALL, EBNO, "cpu")
    assert (mt.Lu, mt.Lp, mt.num_cw, mt.k_user) == \
        (mb.Lu, mb.Lp, mb.num_cw, mb.k_user)
    bits, noise = _draws(mt, 3, seed=2)
    a, b = mt.run_block_from(bits, noise), mb.run_block_from(bits, noise)
    assert {k: v.item() for k, v in a.items()} == \
        {k: v.item() for k, v in b.items()}


def test_run_block_is_a_function_of_the_generator_seed():
    mt = ConcatModel.build(SMALL, EBNO, "cpu")

    def run(block):
        out = mt.run_block(block_generator(5, 0, block), 3)
        return {k: v.item() for k, v in out.items()}

    first = run(0)
    assert first == run(0)
    assert first["trials"] == 3 and 0 <= first["bp_ok"] <= 3
    assert 3 <= first["iters_sum"] <= 3 * mt.sparc.cfg.amp_iters


def test_in_kernel_noise_is_not_ported():
    """Ported since: the shipped in-kernel noise runs; the same generator
    gives the same counters, and BP decodes every codeword here."""
    cfg = SMALL.replace(sparc=SMALL.sparc.replace(amp_noise_in_kernel=True))
    mt = ConcatModel.build(cfg, EBNO, "cpu")

    def run(block):
        return {k: v.item() for k, v in
                mt.run_block(block_generator(0, 0, block), 4).items()}

    out = run(0)
    assert out == run(0)
    assert out["trials"] == 4 and out["bp_ok"] == 4
    assert out != run(1)


def test_both_amp_passes_see_the_same_noise(monkeypatch):
    """The pinned feedback pass takes the main pass's seeds, so the plain
    version draws the identical channel noise twice."""
    import sparc_ldpc_tpu_torch.ops.amp_kernel as amp_mod

    cfg = SMALL.replace(sparc=SMALL.sparc.replace(amp_noise_in_kernel=True))
    mt = ConcatModel.build(cfg, EBNO, "cpu")
    drawn = []
    real = amp_mod.channel_noise_reference

    def record(*args):
        drawn.append(real(*args))
        return drawn[-1]

    monkeypatch.setattr(amp_mod, "channel_noise_reference", record)
    mt.run_block(block_generator(1, 0, 0), 3)
    assert len(drawn) == 2
    assert torch.equal(drawn[0], drawn[1])
    assert drawn[0].abs().sum() > 0


def test_pallas_concat_takes_the_scan_route_like_jax(monkeypatch):
    """use_pallas on a fused concat config: as in the reference, the
    operator has no row mask, so both AMP passes run the scan route
    (fwht2, denoise_kernel) with the encode and the noise outside; against
    the reference's --pallas chain in interpret mode, identical user bits
    and ok flags."""
    import functools

    import sparc_ldpc_tpu.models.amp as jamp_mod
    import sparc_ldpc_tpu.ops.operators as jops_mod
    import sparc_ldpc_tpu_torch.models.amp as tamp_mod
    from sparc_ldpc_tpu.ops.denoiser import denoise_pallas
    from sparc_ldpc_tpu.ops.fwht import fwht_pallas

    monkeypatch.setattr(jops_mod, "fwht_pallas",
                        functools.partial(fwht_pallas, interpret=True))
    monkeypatch.setattr(jamp_mod, "denoise_pallas",
                        functools.partial(denoise_pallas, interpret=True))

    def no_fused(*a, **k):
        raise AssertionError("the --pallas route must not reach amp_fused")

    monkeypatch.setattr(tamp_mod, "amp_fused", no_fused)
    cfg = SMALL.replace(sparc=SMALL.sparc.replace(amp_noise_in_kernel=True))
    mj = JConcat.build(cfg, EBNO, use_pallas=True)
    mt = ConcatModel.build(cfg, EBNO, "cpu", use_pallas=True)
    assert not mt.sparc.enc_in_kernel and not mt.sparc.noise_in_kernel
    bits, noise = _draws(mt, 4, seed=3)
    y = np.asarray(mj.encode(jnp.asarray(bits))) \
        + noise * np.float32(math.sqrt(mj.sparc.sigma2))
    dj = mj.decode(jnp.asarray(y))
    dt = mt.decode(torch.tensor(y))
    for k in ("user_bits", "bp_ok"):
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(dt["tau2_final"].numpy(),
                               np.asarray(dj["tau2_final"]), rtol=1e-4)
    out = {k: v.item() for k, v in mt.run_block_from(bits, noise).items()}
    assert {k: out[k] for k in ("bit_errors", "frame_errors")} == \
        {k: v for k, v in _counters(bits, dj["user_bits"]).items()
         if k != "bit_errors_sq"}
    run = {k: v.item() for k, v in
           mt.run_block(block_generator(2, 0, 0), 2).items()}
    assert run["trials"] == 2
