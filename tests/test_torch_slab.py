"""The slab form of the port's fused AMP (K7, amp_kernel="fused_slab")
against the JAX reference on the CPU.

The reference's `amp_fused(form="slab")` runs its Pallas kernel
`_amp_kernel_slab` in interpret mode; the port's `amp_fused_reference(
form="slab")` is the plain version of csrc/amp_slab.cu, which the card
holds to it (tests/test_torch_cuda.py, chip_smoke.py phases 24-26).  Both
round each transform's data to bf16 before H_M and before H_L and add
tau2 and |beta'|^2 per slab, then over the slabs in order, so only
summation order differs: tau2 agrees to about 1e-6 over the first
iterations, and a value that crosses a bf16 rounding boundary grows that
to a few 1e-3 by T=8 (hence rtol 5e-3, as for the mono form).  Decisions
are margin-aware (tests/test_precision.py assert_decisions_match); with
tol 1e-2 the iteration counts are equal per codeword.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import SparcConfig as JConfig
from sparc_ldpc_tpu.models.amp import hard_indices as j_hard_indices
from sparc_ldpc_tpu.models.sparc import SparcModel as JModel
from sparc_ldpc_tpu.ops.amp_kernel import amp_fused as j_amp_fused
from sparc_ldpc_tpu.utils import rng as jrng
from test_precision import assert_decisions_match
from test_torch_amp import _fused_inputs, _stop_inputs, _t

import sparc_ldpc_tpu_torch.ops.amp_kernel as ak
from sparc_ldpc_tpu_torch.config import ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu_torch.models.concat import ConcatModel
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, slab_geometry)
from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

SHAPES = [(256, 64), (64, 256), (256, 256)]


def _j_slab(d, T, tol=0.0, **arrays):
    """The reference's slab kernel in interpret mode on d's inputs."""
    return j_amp_fused(jnp.asarray(d.y_n), jnp.asarray(d.mask),
                       jnp.asarray(d.sq), d.cfg.P, d.cfg.n, T,
                       interpret=True, form="slab", tol=tol,
                       **{k: jnp.asarray(v) for k, v in arrays.items()})


def _t_slab(d, T, tol=0.0, **arrays):
    """The port's plain slab form on the same inputs."""
    return amp_fused_reference(_t(d.y_n), _t(d.mask), _t(d.sq), d.cfg.P,
                               d.cfg.n, T, form="slab", tol=tol,
                               **{k: _t(v) for k, v in arrays.items()})


def test_slab_geometry_is_the_reference_one():
    """f_b = min(128, L), m_b = 128 when 128 divides M > 128, else M
    (sparc_ldpc_tpu/ops/amp_kernel.py:910-917)."""
    assert slab_geometry(1024, 512) == (8, 128, 4, 128)
    assert slab_geometry(4096, 1024) == (32, 128, 8, 128)
    assert slab_geometry(64, 256) == (1, 64, 2, 128)
    assert slab_geometry(32, 128) == (1, 32, 1, 128)
    assert slab_geometry(256, 64) == (2, 128, 1, 64)


@pytest.mark.parametrize("L,M", SHAPES)
def test_slab_plain_matches_jax_slab_kernel(L, M):
    """Fixed T: equal decisions, tau2 to rtol 5e-3, every codeword all T
    iterations."""
    d = _stop_inputs(5.0, 8, 3, seed=2, L=L, M=M)
    T = d.cfg.amp_iters
    bj, tj = _j_slab(d, T)
    bt, tt, it = _t_slab(d, T)
    assert bt.shape == (3, L, M) and tt.shape == (T, 3)
    assert it.tolist() == [T] * 3
    assert_decisions_match(np.asarray(bj), bt.numpy())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)


@pytest.mark.parametrize("L,M", SHAPES)
def test_slab_plain_early_stop_matches_jax(L, M):
    """tol 1e-2 (the reference's cross-route tolerance): equal iteration
    counts per codeword, equal decisions, frozen trace entries repeat the
    last tau2."""
    d = _stop_inputs(6.0, 12, 4, seed=0, L=L, M=M)
    T = d.cfg.amp_iters
    bj, tj, ij = _j_slab(d, T, tol=1e-2)
    bt, tt, it = _t_slab(d, T, tol=1e-2)
    ij = np.asarray(ij)
    assert int(ij.max()) < T, "the point must stop early"
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(bt.numpy().argmax(-1),
                                  np.asarray(bj).argmax(-1))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)
    tr = tt.numpy()
    for b, used in enumerate(it.tolist()):
        assert np.all(tr[used:, b] == tr[used - 1, b])


@pytest.mark.parametrize("L,M", SHAPES)
def test_slab_plain_pins_and_schedule_match_jax(L, M):
    """Pinning (random targets on 40 % of the rows) and an SE schedule
    (the reference's, tests/test_precision.py:349-351, from 1 + sigma2
    down to sigma2): equal decisions, tau2 to rtol 5e-3, pinned rows
    exactly sq * one_hot, the trace the schedule."""
    d = _stop_inputs(6.0, 10, 3, seed=7, L=L, M=M)
    cfg, B, T = d.cfg, 3, d.cfg.amp_iters
    pin_mask = d.rng.random((B, L)) < 0.4
    pin_idx = np.where(pin_mask, d.rng.integers(0, M, (B, L)),
                       -1).astype(np.int32)
    s2 = d.model.sigma2
    sched = np.geomspace(1.0 + s2, s2, T).astype(np.float32)
    for kw in (dict(pin_idx=pin_idx), dict(tau2_schedule=sched)):
        bj, tj = _j_slab(d, T, **kw)
        bt, tt, _ = _t_slab(d, T, **kw)
        assert_decisions_match(np.asarray(bj), bt.numpy())
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)
    np.testing.assert_array_equal(tt.numpy(),
                                  np.broadcast_to(sched[:, None], (T, B)))
    bt, _, _ = _t_slab(d, T, pin_idx=pin_idx)
    sqo = _t(d.sq).reshape(1, L, 1) * math.sqrt(cfg.n)
    want = torch.where(torch.arange(M) == _t(pin_idx)[..., None].long(),
                       sqo, 0.0) * (1.0 / math.sqrt(cfg.n))
    pinned = _t(pin_mask)
    assert torch.equal(bt[pinned], want[pinned])


@pytest.mark.parametrize("L,M", SHAPES)
def test_slab_plain_encode_matches_jax(L, M):
    """The in-kernel encode: the port encodes in float32, the reference in
    two bf16 passes (hi, lo) good to about 2^-16, so the decodes agree as
    at fixed T."""
    d = _fused_inputs(L, M, B=3, seed=4)
    T = d.cfg.amp_iters
    bj, tj = _j_slab(d, T, encode_idx=d.idx)
    bt, tt, _ = _t_slab(d, T, encode_idx=d.idx)
    assert_decisions_match(np.asarray(bj), bt.numpy())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=5e-3)


def test_slab_sums_tau2_per_slab():
    """tau2 and |beta'|^2 are the per-slab partial sums, added in slab
    order; the split form sums the whole tile.  The transforms are the
    same, so the two plain versions agree to float32 summation order at
    the first iteration, which has no beta' yet."""
    d = _stop_inputs(5.0, 1, 2, seed=3, L=256, M=64)
    args = (_t(d.y_n), _t(d.mask), _t(d.sq), d.cfg.P, d.cfg.n, 1)
    _, t_slab, _ = amp_fused_reference(*args, form="slab")
    _, t_split, _ = amp_fused_reference(*args, split=True)
    y = torch.where(_t(d.mask) > 0, _t(d.y_n), 0.0)
    parts = (y * y).reshape(2, 2, -1).sum(-1)
    assert torch.equal(t_slab[0], (parts[:, 0] + parts[:, 1]) / d.cfg.n)
    np.testing.assert_allclose(t_slab.numpy(), t_split.numpy(), rtol=1e-6)


def test_amp_fused_slab_on_cpu_runs_the_plain_version_without_launch():
    d = _fused_inputs(64, 128)
    args = (_t(d.y_n), _t(d.mask), _t(d.sq), d.cfg.P, d.cfg.n, 4)
    counts = (amp_fused.launches, amp_fused.mono_launches,
              amp_fused.slab_launches)
    b1, t1, i1 = amp_fused(*args, encode_idx=_t(d.idx), form="slab")
    b2, t2, i2 = amp_fused_reference(*args, encode_idx=_t(d.idx),
                                     form="slab")
    assert (amp_fused.launches, amp_fused.mono_launches,
            amp_fused.slab_launches) == counts
    assert torch.equal(b1, b2) and torch.equal(t1, t2)
    assert torch.equal(i1, i2)


# ------------------------------------------------------ the config path

def _reference_draws(key, B, k_bits, n):
    """The bits and standard-normal noise that the reference's tests draw
    from jax.random.key(key) (folds 0 and 1), as NumPy arrays."""
    key = jax.random.key(key)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5, (B, k_bits))
    noise = jax.random.normal(jax.random.fold_in(key, 1), (B, n))
    return np.asarray(bits).astype(np.int32), np.array(noise, np.float32)


@pytest.mark.parametrize("L,M", SHAPES)
def test_fused_slab_config_path_matches_jax_xla(L, M):
    """amp_kernel="fused_slab" through the port's SparcModel against the
    reference's XLA scan, tests/test_precision.py:362-387 on its draws, at
    its shapes and tolerances: identical decisions, tau2 to rtol 2e-2, beta
    to rtol/atol 5e-2; and against the reference's own fused_slab route
    (interpret mode) to the slab kernel's rtol 5e-3."""
    kw = dict(L=L, M=M, R=1.0, op_kind="hadamard", amp_iters=8,
              amp_tol=0.0, transform_precision="bf16",
              amp_kernel="fused_slab")
    jslab = JModel.build(JConfig(**kw), ebno_db=5.0)
    jref = JModel.build(JConfig(**kw).replace(amp_kernel="xla"), ebno_db=5.0)
    m = SparcModel.build(SparcConfig(**kw), 5.0, "cpu")
    bits, noise = _reference_draws(7, 2, m.cfg.k_bits, m.cfg.n)
    y = np.asarray(jslab.encode(jnp.asarray(bits))) \
        + noise * np.float32(np.sqrt(jslab.sigma2))
    r_ref = jref.decode(jnp.asarray(y))
    r_js = jslab.decode(jnp.asarray(y), fused_interpret=True)
    r = m.decode(torch.tensor(y))
    np.testing.assert_array_equal(np.asarray(j_hard_indices(r_ref.beta)),
                                  r.beta.argmax(-1).numpy())
    np.testing.assert_allclose(r.tau2_trace.numpy(),
                               np.asarray(r_ref.tau2_trace), rtol=2e-2)
    np.testing.assert_allclose(r.beta.numpy(), np.asarray(r_ref.beta),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(r.tau2_trace.numpy(),
                               np.asarray(r_js.tau2_trace), rtol=5e-3)


def test_amp_tol_parity_across_routes():
    """The reference's tests/test_parallel.py:129-165 on the port, on its
    draws (trial keys of base key 5, folds 0 and 1), at 6 dB with tol 1e-4
    and the codeword encoded outside the kernel, so every route decodes
    the same y: "xla", "fused" (mono at L = 64), "fused_split" and
    "fused_slab" give the reference's error counters, and "xla",
    "fused_split" and "fused_slab" its iters_sum (133), the stop engaged;
    the slab form stops every codeword where the split form does (the two
    share their transforms and differ in summation order only).  The
    port's mono form stops one codeword one iteration earlier than the
    reference's mono kernel here (132): its H_L is float32 butterflies
    where the reference multiplies by a dense H_L, and at tol 1e-4 a
    low-bit tau2 difference moves a stop by one, the reference's own
    caveat in that test's docstring.  On a virtual (2 x 1) mesh
    "fused_slab" equals "fused" bit for bit: a policy takes no form (the
    reference's amp_fused_sharded takes fused_split alone), so both run
    the mono form per data shard."""
    T, B = 16, 16
    base = dict(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=T,
                amp_tol=1e-4, transform_precision="bf16",
                amp_encode_in_kernel=False)
    jcfg = JConfig(**base, amp_kernel="xla")
    tkeys = jrng.trial_keys(jrng.base_key(5), B)
    keys = ("bit_errors", "frame_errors", "section_errors", "iters_sum")
    ref = {k: int(v) for k, v in
           jax.jit(JModel.build(jcfg, ebno_db=6.0).run_block)(tkeys).items()
           if k in keys}
    assert ref["iters_sum"] < T * B, "early stop never engaged"
    fold = jax.vmap(lambda k, i: jax.random.fold_in(k, i), (0, None))
    bits = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jcfg.k_bits,)))(fold(tkeys, 0))).astype(np.int32)
    noise = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (jcfg.n,), dtype=jnp.float32))(fold(tkeys, 1)))
    models = {kern: SparcModel.build(SparcConfig(**base, amp_kernel=kern),
                                     6.0, "cpu")
              for kern in ("xla", "fused", "fused_split", "fused_slab")}
    got = {kern: {k: int(v) for k, v in m.run_block_from(bits, noise).items()
                  if k in keys} for kern, m in models.items()}
    for kern in ("xla", "fused_split", "fused_slab"):
        assert got[kern] == ref, (kern, got[kern], ref)
    assert {k: got["fused"][k] for k in keys[:3]} == \
        {k: ref[k] for k in keys[:3]}
    assert abs(got["fused"]["iters_sum"] - ref["iters_sum"]) <= 1
    y = models["fused_slab"].encode(torch.tensor(bits)) + torch.tensor(
        noise) * float(np.sqrt(models["fused_slab"].sigma2))
    assert torch.equal(models["fused_slab"].decode(y).iters,
                       models["fused_split"].decode(y).iters)
    pol = ShardingPolicy(make_mesh(1, ["cpu"] * 2))
    dp = {kern: SparcModel.build(SparcConfig(**base, amp_kernel=kern), 6.0,
                                 None, policy=pol).run_block_from(bits, noise)
          for kern in ("fused", "fused_slab")}
    for k, v in dp["fused"].items():
        assert torch.equal(v, dp["fused_slab"][k]), k
    assert int(dp["fused_slab"]["iters_sum"]) == got["fused"]["iters_sum"]


def test_concat_slab_block_runs_both_passes_on_the_slab_form(monkeypatch):
    """A concat block with sparc.amp_kernel="fused_slab" (the small chain
    of tests/test_torch_concat.py): the main pass and the pinned feedback
    pass (pins and tol) both reach the slab form, and on the same draws
    the block's counters are those of the "fused_split" chain."""
    forms = []
    plain = ak.amp_fused_reference
    sig = inspect.signature(plain)

    def spy(*args, **kw):
        a = sig.bind(*args, **kw).arguments
        forms.append((a.get("form"), a.get("pin_idx") is not None))
        return plain(*args, **kw)

    cfg = ConcatConfig(
        sparc=SparcConfig(L=64, M=64, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_slab",
                          amp_tol=1e-4, transform_precision="bf16",
                          amp_iters=16),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        engine="qc", schedule="layered", bp_iters=16),
        f_prot=0.5)
    slab = ConcatModel.build(cfg, 4.0, "cpu")
    split = ConcatModel.build(cfg.replace(sparc=cfg.sparc.replace(
        amp_kernel="fused_split")), 4.0, "cpu")
    assert not slab.sparc.noise_in_kernel
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (6, slab.k_user)).astype(np.int32)
    noise = rng.standard_normal((6, slab.sparc.cfg.n)).astype(np.float32)
    monkeypatch.setattr(ak, "amp_fused_reference", spy)
    got = slab.run_block_from(bits, noise)
    assert forms == [("slab", False), ("slab", True)]
    want = split.run_block_from(bits, noise)
    assert [f for f, _ in forms[2:]] == ["split", "split"]
    for k in ("trials", "frame_errors", "bit_errors", "bp_ok"):
        assert int(got[k]) == int(want[k]), k
