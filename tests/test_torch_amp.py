"""The port's AMP (fused whole-trial route and scan route) against the JAX
reference on the CPU.  The CUDA kernel is held against its plain version
in tests/test_torch_cuda.py and, at full width, by chip_smoke.py.

Tolerances are the reference's own for bf16 transforms: margin-aware
decisions (tests/test_precision.py assert_decisions_match), tau2 traces to
rtol 2e-2, beta to rtol/atol 5e-2.
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.models.amp import amp_decode as j_amp_decode
from sparc_ldpc_tpu.models.sparc import SparcModel as JModel
from sparc_ldpc_tpu.ops.amp_kernel import amp_fused as j_amp_fused
from sparc_ldpc_tpu.utils.bits import np_bits_to_indices
from test_precision import assert_decisions_match

from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.models.amp import (
    AmpResult, amp_decode, decision_flips, hard_indices)
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, channel_noise_reference)
from sparc_ldpc_tpu_torch.ops.denoiser import denoise_kernel
from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2
from sparc_ldpc_tpu_torch.ops.operators import hadamard_operator


def _t(a):
    return torch.tensor(np.asarray(a))


def _fused_inputs(L, M, B=2, ebno_db=5.0, seed=0):
    """NumPy inputs of the fused route with in-kernel encode: the scaled
    channel noise y (B, n) and its embedding y_n (B, L, M) on the row
    support, the true section indices, and the JAX model's constants."""
    cfg = SparcConfig(L=L, M=M, R=1.0, op_kind="hadamard", amp_iters=8,
                      amp_tol=0.0, transform_precision="bf16",
                      amp_kernel="fused_split")
    m = JModel.build(cfg, ebno_db=ebno_db)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, cfg.k_bits))
    noise = rng.standard_normal((B, cfg.n)).astype(np.float32)
    y = noise * np.float32(np.sqrt(m.sigma2))
    y_n = np.asarray(m.op.embed_y(jnp.asarray(y))).reshape(B, L, M)
    idx = np_bits_to_indices(bits, cfg.logM).astype(np.int32)
    mask = np.asarray(m.op.mask).reshape(L, M)
    return SimpleNamespace(cfg=cfg, model=m, y=y, y_n=y_n, mask=mask,
                           sq=np.asarray(m.sq_npl), idx=idx)


@pytest.mark.parametrize("L,M", [(256, 64), (64, 256), (256, 256)])
def test_amp_fused_reference_matches_jax_split_kernel(L, M):
    d = _fused_inputs(L, M)
    cfg, T = d.cfg, d.cfg.amp_iters
    bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                         jnp.asarray(d.sq), cfg.P, cfg.n, T, interpret=True,
                         split=True, encode_idx=jnp.asarray(d.idx))
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), cfg.P,
                                     cfg.n, T, encode_idx=_t(d.idx),
                                     split=True)
    bj, tj = np.asarray(bj), np.asarray(tj)
    assert bt.shape == bj.shape and tt.shape == tj.shape == (T, 2)
    assert it.tolist() == [T, T]
    assert_decisions_match(bj, bt.numpy())
    np.testing.assert_allclose(tt.numpy(), tj, rtol=2e-2)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=5e-2, atol=5e-2)


def test_amp_fused_on_cpu_runs_the_plain_version_without_launch():
    d = _fused_inputs(64, 128)
    args = (_t(d.y_n), _t(d.mask), _t(d.sq), d.cfg.P, d.cfg.n,
            d.cfg.amp_iters)
    launches = amp_fused.launches
    b1, t1, i1 = amp_fused(*args, encode_idx=_t(d.idx))
    b2, t2, i2 = amp_fused_reference(*args, encode_idx=_t(d.idx))
    assert amp_fused.launches == launches
    assert torch.equal(b1, b2) and torch.equal(t1, t2)
    assert torch.equal(i1, i2)


@pytest.mark.parametrize("option", [
    dict(noise_seed=torch.zeros(2, 2, dtype=torch.int32)),
    dict(noise_seed=torch.zeros(2, 2, dtype=torch.int32), noise_sigma=0.5,
         encode_idx=None)])
def test_amp_fused_unported_options_raise(option):
    """The in-kernel noise is ported; what the reference refuses still
    raises: seeds next to a y_n, seeds without encode_idx."""
    d = _fused_inputs(64, 128)
    kw = {"encode_idx": _t(d.idx), **option}
    with pytest.raises(ValueError):
        amp_fused(_t(d.y_n), _t(d.mask), _t(d.sq), d.cfg.P, d.cfg.n, 8, **kw)


def test_amp_fused_noise_route_is_the_explicit_noise_route():
    """noise_seed draws channel_noise_reference's noise: the same decode as
    passing that noise as y_n."""
    d = _fused_inputs(64, 128)
    seeds = torch.tensor([[1, 2], [-3, 2 ** 31 - 1]], dtype=torch.int32)
    sigma = math.sqrt(d.model.sigma2)
    args = (_t(d.mask), _t(d.sq), d.cfg.P, d.cfg.n, 8)
    kw = dict(encode_idx=_t(d.idx), precision="highest", split=True)
    b1, t1, i1 = amp_fused(None, *args, noise_seed=seeds, noise_sigma=sigma,
                           **kw)
    y_n = channel_noise_reference(seeds, _t(d.mask), sigma)
    b2, t2, i2 = amp_fused(y_n, *args, **kw)
    assert torch.equal(b1, b2) and torch.equal(t1, t2)
    assert torch.equal(i1, i2)


def test_amp_fused_encode_matches_explicit_codeword():
    """In-kernel encode == decoding y = mask o (A beta0) + noise with
    encode_idx=None (the codeword synthesized outside)."""
    d = _fused_inputs(64, 128)
    cfg = d.cfg.replace(transform_precision="highest")
    op = hadamard_operator(cfg)
    beta0 = torch.nn.functional.one_hot(_t(d.idx).long(), cfg.M).float()
    beta0 = (_t(d.sq)[None, :, None] * beta0).reshape(2, cfg.ML)
    x_n = op.embed_y(op.Ax(beta0)).reshape(2, cfg.L, cfg.M)
    args = (_t(d.mask), _t(d.sq), cfg.P, cfg.n, cfg.amp_iters)
    b1, t1, _ = amp_fused(_t(d.y_n), *args, encode_idx=_t(d.idx),
                          precision="highest", split=True)
    b2, t2, _ = amp_fused(_t(d.y_n) + x_n, *args, precision="highest",
                          split=True)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), rtol=1e-5)
    np.testing.assert_allclose(b1.numpy(), b2.numpy(), atol=1e-4)


# ------------------------------------------------------------- scan route

@pytest.mark.parametrize("variant", [
    dict(), dict(amp_tol=1e-3), dict(tau_mode="se"),
    dict(amp_residual_space="N", amp_tol=1e-3)])
def test_scan_amp_decode_matches_jax_scan(variant):
    cfg = SparcConfig(L=64, M=128, R=1.0, op_kind="hadamard", amp_iters=12,
                      amp_tol=0.0, transform_precision="highest"
                      ).replace(**variant)
    m = JModel.build(cfg, ebno_db=6.0)
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, cfg.k_bits))
    noise = rng.standard_normal((3, cfg.n)).astype(np.float32)
    y = np.asarray(m.encode(jnp.asarray(bits))) \
        + noise * np.float32(np.sqrt(m.sigma2))
    rj = m.decode(jnp.asarray(y))
    sched = (None if m.tau2_schedule is None
             else _t(m.tau2_schedule))
    rt = amp_decode(_t(y), hadamard_operator(cfg), _t(m.sq_npl), cfg.P,
                    cfg.n, T=cfg.amp_iters, tol=cfg.amp_tol,
                    tau2_schedule=sched,
                    residual_space=cfg.amp_residual_space)
    assert isinstance(rt, AmpResult)
    assert_decisions_match(np.asarray(rj.beta), rt.beta.numpy())
    np.testing.assert_array_equal(hard_indices(rt.beta).numpy(),
                                  np.asarray(rj.beta).argmax(-1))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.tau2_trace.numpy(),
                               np.asarray(rj.tau2_trace), rtol=1e-4)
    np.testing.assert_allclose(rt.posteriors.numpy(),
                               np.asarray(rj.posteriors), atol=1e-4)
    if cfg.amp_tol:
        assert int(rt.iters.max()) < cfg.amp_iters, "early stop not engaged"


def test_fused_amp_decode_matches_jax_fused_route():
    """amp_decode(fused=True, encode_idx=...) end to end against the JAX
    fused route in interpret mode."""
    d = _fused_inputs(64, 256, B=3, seed=1)
    cfg, m = d.cfg, d.model
    rj = j_amp_decode(jnp.asarray(d.y), m.op, m.sq_npl, cfg.P, cfg.n,
                      T=cfg.amp_iters, tol=0.0, fused=True,
                      fused_interpret=True, fused_split=True,
                      encode_idx=jnp.asarray(d.idx))
    rt = amp_decode(_t(d.y), hadamard_operator(cfg), _t(d.sq), cfg.P, cfg.n,
                    T=cfg.amp_iters, tol=0.0, fused=True, fused_split=True,
                    encode_idx=_t(d.idx))
    assert_decisions_match(np.asarray(rj.beta), rt.beta.numpy())
    np.testing.assert_allclose(rt.tau2_trace.numpy(),
                               np.asarray(rj.tau2_trace), rtol=2e-2)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))


def test_decision_flips_follows_assert_decisions_match():
    rng = np.random.default_rng(6)
    a = rng.random((2, 16, 8)) + 0.1
    b = a.copy()
    b[0, 3] = a[0, 3][::-1]                       # a decisive flip
    a[1, 5, :2] = [1.0, 0.999]                    # a near-tie ...
    b[1, 5, :2] = [0.999, 1.0]                    # ... that flips
    a[1, 5, 2:] = b[1, 5, 2:] = 0.1
    flips, decisive = decision_flips(a, b)
    assert (flips, decisive) == (2, 1)
    with pytest.raises(AssertionError):
        assert_decisions_match(a, b)
    b[0, 3] = a[0, 3]
    assert decision_flips(torch.tensor(a), torch.tensor(b)) == (1, 0)
    assert_decisions_match(a, b, max_flips=1.0)


# ------------------------------------- early stop, pinning, SE schedule

def _stop_inputs(ebno_db, T, B, seed, L=64, M=64):
    """The reference's early-stop test point (tests/test_precision.py
    test_fused_split_early_stop_*): L = M = 64 at a high SNR, NumPy draws,
    the codeword encoded outside (y is the whole observation)."""
    cfg = SparcConfig(L=L, M=M, R=1.0, op_kind="hadamard", amp_iters=T,
                      amp_tol=1e-4, transform_precision="bf16")
    m = JModel.build(cfg, ebno_db=ebno_db)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, cfg.k_bits))
    noise = rng.standard_normal((B, cfg.n)).astype(np.float32)
    y = np.asarray(m.encode(jnp.asarray(bits))) \
        + noise * np.float32(np.sqrt(m.sigma2))
    y_n = np.asarray(m.op.embed_y(jnp.asarray(y))).reshape(B, L, M)
    return SimpleNamespace(cfg=cfg, model=m, y=y, y_n=y_n, rng=rng,
                           mask=np.asarray(m.op.mask).reshape(L, M),
                           sq=np.asarray(m.sq_npl))


def test_fused_split_with_default_tol_decodes():
    """A fused_split config with the default amp_tol (1e-6) decodes through
    the port, as it does in the reference: the per-codeword freeze on the
    fused route, with the iterations each codeword really used."""
    cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard",
                      amp_kernel="fused_split", amp_iters=16)
    assert cfg.amp_tol == 1e-6
    mj = JModel.build(cfg, ebno_db=6.0)
    mt = SparcModel.build(cfg, 6.0, "cpu")
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, cfg.k_bits))
    y = np.asarray(mj.encode(jnp.asarray(bits))) + rng.standard_normal(
        (3, cfg.n)).astype(np.float32) * np.float32(np.sqrt(mj.sigma2))
    rj = mj.decode(jnp.asarray(y))
    rt = mt.decode(torch.tensor(y))
    assert_decisions_match(np.asarray(rj.beta), rt.beta.numpy())
    # a 1e-6 plateau test sits at float32 rounding noise: the counts agree
    # to the reference's own rule (tests/test_precision.py:448-449)
    it, ij = rt.iters.numpy(), np.asarray(rj.iters)
    assert int(np.max(np.abs(it - ij))) <= 4 and int(it.max()) < 16
    np.testing.assert_allclose(rt.tau2_trace.numpy()[:int(it.min())],
                               np.asarray(rj.tau2_trace)[:int(it.min())],
                               rtol=2e-2)


def test_amp_fused_reference_early_stop_matches_jax_split_kernel():
    """K1 (c): the plain version's per-codeword freeze against the JAX
    split kernel (interpret mode) with tol = 1e-4: equal iteration counts,
    equal decisions, tau2 to rtol 2e-2, frozen trace entries repeated."""
    d = _stop_inputs(6.0, 16, 4, seed=0)
    cfg = d.cfg
    args = (d.mask, d.sq, cfg.P, cfg.n, cfg.amp_iters)
    bj, tj, ij = j_amp_fused(jnp.asarray(d.y_n), *map(jnp.asarray, args[:2]),
                             *args[2:], interpret=True, split=True, tol=1e-4)
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq),
                                     *args[2:], tol=1e-4, split=True)
    ij = np.asarray(ij)
    assert int(ij.max()) < cfg.amp_iters, "the point must stop early"
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(bt.numpy().argmax(-1),
                                  np.asarray(bj).argmax(-1))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-2)
    tr = tt.numpy()
    for b, used in enumerate(it.tolist()):
        assert np.all(tr[used:, b] == tr[used - 1, b])


def test_amp_fused_reference_pinning_with_tol_matches_jax():
    """K1 (c)+(d): early stop and pinning together (the concat feedback
    pass) against the JAX split kernel: iteration counts within 4 (the
    reference's own rule), equal decisions, pinned rows exactly
    sq * one_hot in true scale."""
    d = _stop_inputs(8.0, 12, 3, seed=11)
    cfg, B = d.cfg, 3
    pin_mask = d.rng.random((B, cfg.L)) < 0.4
    pin_idx = np.where(pin_mask, d.rng.integers(0, cfg.M, (B, cfg.L)),
                       -1).astype(np.int32)
    args = (cfg.P, cfg.n, cfg.amp_iters)
    bj, tj, ij = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                             jnp.asarray(d.sq), *args, interpret=True,
                             split=True, tol=1e-4,
                             pin_idx=jnp.asarray(pin_idx))
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), *args,
                                     tol=1e-4, pin_idx=_t(pin_idx),
                                     split=True)
    assert int(np.max(np.abs(it.numpy() - np.asarray(ij)))) <= 4
    np.testing.assert_array_equal(bt.numpy().argmax(-1),
                                  np.asarray(bj).argmax(-1))
    # sq * one_hot in the kernel's scale-free form, then back to true scale
    sqo = _t(d.sq).reshape(1, cfg.L, 1) * math.sqrt(cfg.n)
    want = torch.where(torch.arange(cfg.M) == _t(pin_idx)[..., None].long(),
                       sqo, 0.0) * (1.0 / math.sqrt(cfg.n))
    pinned = _t(pin_mask)
    assert torch.equal(bt[pinned], want[pinned])
    np.testing.assert_array_equal(bt.numpy()[pin_mask].argmax(-1),
                                  pin_idx[pin_mask])


def test_amp_fused_reference_se_schedule_matches_jax():
    """K1 (d): with an SE tau2 schedule the trace IS the schedule, and the
    decode matches the JAX split kernel's on the same schedule."""
    d = _stop_inputs(6.0, 10, 2, seed=4)
    cfg = d.cfg
    sched = np.linspace(0.5, 0.05, cfg.amp_iters).astype(np.float32)
    args = (cfg.P, cfg.n, cfg.amp_iters)
    bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                         jnp.asarray(d.sq), *args, interpret=True,
                         split=True, tau2_schedule=jnp.asarray(sched))
    bt, tt, it = amp_fused(_t(d.y_n), _t(d.mask), _t(d.sq), *args,
                           tau2_schedule=_t(sched), split=True)
    assert torch.equal(tt, _t(sched)[:, None].expand(-1, 2))
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    assert it.tolist() == [cfg.amp_iters] * 2
    assert_decisions_match(np.asarray(bj), bt.numpy())


def test_scan_route_pinning_matches_jax_scan():
    """Decision-feedback pinning on the scan route (one-hot targets and
    index targets) against the JAX scan."""
    d = _stop_inputs(6.0, 10, 3, seed=5)
    cfg = d.cfg.replace(transform_precision="highest")
    m, B = JModel.build(cfg, ebno_db=6.0), 3
    pin_mask = d.rng.random((B, cfg.L)) < 0.4
    pin_idx = d.rng.integers(0, cfg.M, (B, cfg.L)).astype(np.int32)
    onehot = np.eye(cfg.M, dtype=np.float32)[pin_idx]
    kw = dict(T=cfg.amp_iters, tol=1e-4)
    rj = j_amp_decode(jnp.asarray(d.y), m.op, m.sq_npl, cfg.P, cfg.n,
                      pinned_onehot=jnp.asarray(onehot),
                      pinned_mask=jnp.asarray(pin_mask), **kw)
    op = hadamard_operator(cfg)
    for pins in (dict(pinned_onehot=_t(onehot)), dict(pinned_idx=_t(pin_idx))):
        rt = amp_decode(_t(d.y), op, _t(d.sq), cfg.P, cfg.n,
                        pinned_mask=_t(pin_mask), **pins, **kw)
        np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
        np.testing.assert_array_equal(hard_indices(rt.beta).numpy(),
                                      np.asarray(rj.beta).argmax(-1))
        np.testing.assert_array_equal(
            rt.beta.numpy().argmax(-1)[pin_mask], pin_idx[pin_mask])


# ----------------------------------------------------- the --pallas route

def test_pallas_scan_route_matches_jax_pallas_route(monkeypatch):
    """The whole --pallas scan AMP: the port's SparcModel (fwht2 and
    denoise_kernel, their plain versions on the CPU) against the
    reference's, whose fwht_pallas and denoise_pallas run in interpret mode
    (patched here; the reference's files are untouched)."""
    import functools

    import sparc_ldpc_tpu.models.amp as jamp_mod
    import sparc_ldpc_tpu.ops.operators as jops_mod
    from sparc_ldpc_tpu.ops.denoiser import denoise_pallas
    from sparc_ldpc_tpu.ops.fwht import fwht_pallas

    monkeypatch.setattr(jops_mod, "fwht_pallas",
                        functools.partial(fwht_pallas, interpret=True))
    monkeypatch.setattr(jamp_mod, "denoise_pallas",
                        functools.partial(denoise_pallas, interpret=True))
    cfg = SparcConfig(L=32, M=64, R=1.0, power_alloc="iterative",
                      op_kind="hadamard")
    mj = JModel.build(cfg, 6.0, use_pallas=True)
    mt = SparcModel.build(cfg, 6.0, "cpu", use_pallas=True)
    assert mt.op.mask is None and mt.op.embed_y is None
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (4, cfg.k_bits)).astype(np.int32)
    noise = rng.standard_normal((4, cfg.n)).astype(np.float32)
    y = np.asarray(mj.encode(jnp.asarray(bits))) \
        + noise * np.float32(math.sqrt(mj.sigma2))
    np.testing.assert_allclose(
        mt.encode(torch.tensor(bits)).numpy(),
        np.asarray(mj.encode(jnp.asarray(bits))), rtol=1e-5, atol=1e-5)
    rj = mj.decode(jnp.asarray(y), T=16)
    launches = (fwht2.launches, denoise_kernel.launches, amp_fused.launches)
    rt = mt.decode(torch.tensor(y), T=16)
    assert (fwht2.launches, denoise_kernel.launches,
            amp_fused.launches) == launches
    np.testing.assert_allclose(rt.tau2_trace.numpy(),
                               np.asarray(rj.tau2_trace), rtol=1e-4)
    assert decision_flips(rt.beta, np.array(rj.beta))[1] == 0
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))


# -------------------------------------------- the mono form (K6), L > 1024

MONO_SHAPES = [(64, 64), (128, 64)]


@pytest.mark.parametrize("L,M", MONO_SHAPES)
def test_amp_fused_reference_mono_matches_jax_mono_kernel(L, M):
    """K6's plain version against the reference's `_amp_kernel`
    (split=False, interpret mode) at fixed T: both round each transform's
    data to bf16 once, before H_M, and apply H_L in float32, so only
    summation order differs: tau2 agrees to about 1e-6 over the first
    iterations, and a value that crosses a bf16 rounding boundary grows
    that to about 2e-3 by T=8 (hence rtol 5e-3, against the split form's
    2e-2 above)."""
    d = _stop_inputs(5.0, 8, 3, seed=2, L=L, M=M)
    args = (d.cfg.P, d.cfg.n, d.cfg.amp_iters)
    bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                         jnp.asarray(d.sq), *args, interpret=True,
                         split=False)
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), *args,
                                     form="mono")
    assert it.tolist() == [d.cfg.amp_iters] * 3
    assert_decisions_match(np.asarray(bj), bt.numpy())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)


@pytest.mark.parametrize("L,M", MONO_SHAPES)
def test_amp_fused_reference_mono_early_stop_matches_jax(L, M):
    """The mono form's per-codeword freeze with tol 1e-2 (the reference's
    own cross-route tolerance, tests/test_precision.py): equal iteration
    counts, equal decisions, frozen trace entries repeated."""
    d = _stop_inputs(6.0, 12, 4, seed=0, L=L, M=M)
    args = (d.cfg.P, d.cfg.n, d.cfg.amp_iters)
    bj, tj, ij = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                             jnp.asarray(d.sq), *args, interpret=True,
                             split=False, tol=1e-2)
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), *args,
                                     tol=1e-2, form="mono")
    ij = np.asarray(ij)
    assert int(ij.max()) < d.cfg.amp_iters, "the point must stop early"
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(bt.numpy().argmax(-1),
                                  np.asarray(bj).argmax(-1))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)
    tr = tt.numpy()
    for b, used in enumerate(it.tolist()):
        assert np.all(tr[used:, b] == tr[used - 1, b])


@pytest.mark.parametrize("L,M", MONO_SHAPES)
def test_amp_fused_reference_mono_pins_and_schedule_match_jax(L, M):
    """Pinning (random targets on 40 % of the rows) and an SE schedule on
    the mono form against the reference's: equal decisions, pinned rows
    exactly sq * one_hot, the trace the schedule."""
    d = _stop_inputs(6.0, 10, 3, seed=7, L=L, M=M)
    cfg, B = d.cfg, 3
    pin_mask = d.rng.random((B, L)) < 0.4
    pin_idx = np.where(pin_mask, d.rng.integers(0, M, (B, L)),
                       -1).astype(np.int32)
    sched = np.linspace(0.5, 0.05, cfg.amp_iters).astype(np.float32)
    args = (cfg.P, cfg.n, cfg.amp_iters)
    for kw in (dict(pin_idx=pin_idx), dict(tau2_schedule=sched)):
        bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                             jnp.asarray(d.sq), *args, interpret=True,
                             split=False,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        bt, tt, _ = amp_fused_reference(
            _t(d.y_n), _t(d.mask), _t(d.sq), *args, form="mono",
            **{k: _t(v) for k, v in kw.items()})
        assert_decisions_match(np.asarray(bj), bt.numpy())
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)
    np.testing.assert_array_equal(tt.numpy(),
                                  np.broadcast_to(sched[:, None], (10, B)))
    bt, _, _ = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), *args,
                                   form="mono", pin_idx=_t(pin_idx))
    sqo = _t(d.sq).reshape(1, L, 1) * math.sqrt(cfg.n)
    want = torch.where(torch.arange(M) == _t(pin_idx)[..., None].long(),
                       sqo, 0.0) * (1.0 / math.sqrt(cfg.n))
    pinned = _t(pin_mask)
    assert torch.equal(bt[pinned], want[pinned])


@pytest.mark.parametrize("L,M", MONO_SHAPES)
def test_amp_fused_reference_mono_encode_matches_jax(L, M):
    """The in-kernel encode on the mono form: the port encodes in float32,
    the reference in two bf16 passes (hi, lo) good to about 2^-16, so the
    decodes agree as at fixed T."""
    d = _fused_inputs(L, M, B=3, seed=4)
    cfg, T = d.cfg, d.cfg.amp_iters
    bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                         jnp.asarray(d.sq), cfg.P, cfg.n, T, interpret=True,
                         split=False, encode_idx=jnp.asarray(d.idx))
    bt, tt, _ = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), cfg.P,
                                    cfg.n, T, encode_idx=_t(d.idx))
    assert_decisions_match(np.asarray(bj), bt.numpy())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)


def test_amp_fused_routes_as_the_reference():
    """form=None: mono at L <= 1024, split above; split=True forces the
    split form; mono refuses L > 1024 and the in-kernel noise; the slab
    form runs when asked for, up to L = 4096, without the noise."""
    from sparc_ldpc_tpu_torch.ops.amp_kernel import fused_form

    assert fused_form(1024) == "mono" and fused_form(2048) == "split"
    assert fused_form(64, split=True) == "split"
    assert fused_form(64, split=False) == fused_form(64, form="mono")
    assert fused_form(64, split=True, noise=True) == "split"
    assert fused_form(4096, noise=True) == "split"
    with pytest.raises(ValueError):
        fused_form(2048, form="mono")
    with pytest.raises(ValueError):
        fused_form(64, noise=True)
    with pytest.raises(ValueError):
        fused_form(64, form="dense")
    assert fused_form(64, form="slab") == "slab"
    assert fused_form(4096, split=True, form="slab") == "slab"
    with pytest.raises(ValueError, match="L <= 4096"):
        fused_form(8192, form="slab")
    with pytest.raises(ValueError, match="split form only"):
        fused_form(64, form="slab", noise=True)


def test_amp_fused_reference_split_matches_jax_at_l2048():
    """K1 (f): the split form's plain version against the reference's
    split kernel (interpret mode) above L = 1024, where "fused" routes to
    it by itself: L=2048, M=32, B=2, T=4.  Both round before H_M and
    before H_L (the reference's H_fa butterflies follow its bf16 H_fb
    product, which is the same rounding), so only the encode (float32
    against hi/lo bf16) and summation order differ: tau2 to rtol 2e-3;
    decisions with chip_smoke.py's bf16 rule, at most 1 % flipped, since
    a near-tie section still early in the decode can flip either way."""
    d = _fused_inputs(2048, 32, B=2, ebno_db=8.0, seed=5)
    cfg, T = d.cfg, 4
    bj, tj = j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                         jnp.asarray(d.sq), cfg.P, cfg.n, T, interpret=True,
                         encode_idx=jnp.asarray(d.idx))
    bt, tt, it = amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), cfg.P,
                                     cfg.n, T, encode_idx=_t(d.idx))
    assert it.tolist() == [T, T]
    assert decision_flips(np.array(bj), bt)[0] <= 0.01 * 2 * cfg.L
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-3)
