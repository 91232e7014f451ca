"""The port of the slab AMP kernel's stage ablation (ops/amp_slab_exp.py
and the tool slab_ablation) against the reference's own TPU kernels:
scripts/slab_ablation.py `make_kernel`, `make_compact_kernel` and
`make_pair_kernel` (S4), loaded from the script unchanged and run in
Pallas interpret mode on the CPU with the test's own pallas_call (as
tests/test_torch_experiments.py runs S1-S3).

Both sides get the same NumPy draws, encoded by the reference's
SparcModel; the port's model takes the reference's constants
(SparcModel.from_numpy).  Shapes: (L, M) = (256, 256) with f_b = m_b = 64
and (256, 64) with f_b = 64, m_b = 32, so f_a and m_a are at least 2 and
every butterfly runs.  Contracts, per mode:

  decoding (full, fold, fold_hfb, no_trace, exp2, bf16_radix, midbf16,
  fXmY, pair): the bf16 decode contract over T = 3, margin-aware
  decisions (test_precision.py assert_decisions_match: no flip where both
  sides' top-2 margin exceeds 2 %, at most 1 % flips) and the tau2 trace
  to rtol 2e-2 (no_trace: both traces zero); bf16_radix with a 10 %
  margin: its every butterfly rounds to bf16 (four more roundings an
  element and transform at these shapes), and at (256, 256) one section
  of 512 flipped with margins of 2.6 % and 5.0 % by T = 3, where after
  one iteration beta agreed to 3.6e-7 of the scale;
  ablated (no_radix, no_mm, no_softmax, no_consume, sched, fold_sched,
  compact, compactNN): over T = 2, beta within 1e-2 of the script's
  largest |beta|, no NaN on either side; but no_consume, whose function
  is NaN throughout on both sides (its first tau2 is |H(0)|^2 / n = 0).
  Its arithmetic is held instead from a decoded state (the state one
  plain full iteration leaves), against a dense float64 computation with
  the same bf16 roundings: beta within 1e-2 of the scale.

The plain version rounds where the script rounds, so the two differ in
summation order only (after one iteration beta agrees to float32
rounding; three iterations at 2.0 dB amplify a bf16 rounding moved by one
ulp at near-tie sections, which the decode contract allows for).  The
script's bf16 arithmetic (bf16_radix, midbf16) runs in a subprocess with
XLA_FLAGS=--xla_allow_excess_precision=false: by default XLA on the CPU
keeps chains of bf16 adds in float32 and rounds once, where the script's
code (and the card) rounds after every add; so measured at (256, 64),
bf16_radix against the plain version moved 2.4e-2 of the scale with the
flag's default and 1.3e-6 without.
"""

import dataclasses
import functools
import importlib.util
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparc_ldpc_tpu.config import SparcConfig as JSparcConfig
from sparc_ldpc_tpu.models.sparc import SparcModel as JModel
from sparc_ldpc_tpu.ops.fwht import hadamard_factor
from test_precision import assert_decisions_match

from sparc_ldpc_tpu_torch.config import SparcConfig
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused_reference
from sparc_ldpc_tpu_torch.ops.amp_slab_exp import (
    ABLATED, DECODING, DEFAULT_VARIANTS, FACTORINGS, MODES, SCHED_TAU2,
    amp_slab_exp, amp_slab_exp_reference, compact_mask, k7_form_reference,
    parse_mode)
from sparc_ldpc_tpu_torch.tools import slab_ablation
from sparc_ldpc_tpu_torch.tools.kernel_ablation import (draw_block,
                                                        script_config)

TESTS = Path(__file__).resolve().parent
SCRIPT = TESTS.parent / "scripts" / "slab_ablation.py"
EBNO = 2.0
B, T, T_ABLATED = 2, 3, 2
# (L, M) -> (f_b, m_b)
FACTORS = {(256, 256): (64, 64), (256, 64): (64, 32)}
# the modes whose script code has bf16 arithmetic chains
BF16_CHAINS = ("bf16_radix", "midbf16")
# every mode the port names, at one shape or both
CASES = ([(m, (256, 256)) for m in (
    "full", "no_radix", "no_mm", "no_softmax", "no_consume", "bf16_radix",
    "midbf16", "fold", "fold_sched", "fold_hfb", "no_trace", "exp2",
    "sched", "compact", "compact16", "f32m128", "f128m32", "pair")]
    + [(m, (256, 64)) for m in (
        "full", "bf16_radix", "midbf16", "fold_hfb", "compact32", "f32m16",
        "pair")])


def _ablated(mode):
    return mode in ABLATED or mode.startswith("compact")


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location("_slab_ablation", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(mode, y_n, mask, sq, P, n, T, f_b, m_b):
    """The script's kernel of `mode` on y_n (B, L, M) in interpret mode,
    its inputs made as its run_variant and run_pair make them: (beta,
    trace (T, B or B / 2))."""
    S = _script()
    Bn, L, M = y_n.shape
    v = parse_mode(mode, L, M, n, f_b, m_b)
    f_a, m_a = L // v.f_b, M // v.m_b
    args = (T, n, float(P), 1.0 / math.sqrt(n), f_a, v.f_b, m_a, v.m_b)
    C = 2 if v.base == "pair" else 1
    if v.base == "pair":
        kern = S.make_pair_kernel(*args)
    elif v.base == "compact":
        kern = S.make_compact_kernel(*args, v.csub)
    else:
        kern = S.make_kernel(v.base, *args)
    mask2d = jnp.asarray(mask).astype(jnp.bfloat16)
    if v.base in ("fold", "fold_sched"):
        mask2d = jnp.asarray(mask, jnp.float32) / math.sqrt(n)
    hfb = hadamard_factor(v.f_b, jnp.bfloat16)
    if v.base == "fold_hfb":
        hfb = (hadamard_factor(v.f_b, jnp.float32)
               * (1.0 / math.sqrt(n))).astype(jnp.bfloat16)
    tile = (C, L, M)
    beta, trace = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((Bn, L, M), jnp.float32),
                   jax.ShapeDtypeStruct((Bn // C, 8, 128), jnp.float32)),
        grid=(Bn // C,),
        in_specs=[pl.BlockSpec(tile, lambda b: (b, 0, 0)),
                  pl.BlockSpec((L, M), lambda b: (0, 0)),
                  pl.BlockSpec((v.f_b, v.f_b), lambda b: (0, 0)),
                  pl.BlockSpec((v.m_b, v.m_b), lambda b: (0, 0)),
                  pl.BlockSpec((L, 1), lambda b: (0, 0))],
        out_specs=(pl.BlockSpec(tile, lambda b: (b, 0, 0)),
                   pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0))),
        scratch_shapes=[pltpu.VMEM(tile if C > 1 else (L, M),
                                   jnp.float32)] * 2,
        input_output_aliases={0: 0},
        interpret=True,
    )(jnp.asarray(y_n), mask2d, hfb, hadamard_factor(v.m_b, jnp.bfloat16),
      jnp.asarray(sq).reshape(L, 1))
    return (np.asarray(beta),
            np.asarray(trace).reshape(Bn // C, -1)[:, :T].T)


@functools.lru_cache(maxsize=None)
def _models(L, M):
    """The reference model at (L, M), the port's twin on its constants,
    and one block's draws: (mj, mt, y_n (B, L, M) NumPy)."""
    mj = JModel.build(JSparcConfig(
        L=L, M=M, R=1.0, power_alloc="iterative", op_kind="hadamard",
        amp_iters=T, amp_tol=0.0, transform_precision="bf16"), EBNO)
    mask = np.asarray(mj.op.mask)
    params = dict(p_alloc=np.asarray(mj.p_alloc),
                  sq_npl=np.asarray(mj.sq_npl), rows=np.flatnonzero(mask),
                  mask=mask, sigma2=mj.sigma2, amp_iters=mj.cfg.amp_iters)
    mt = SparcModel.from_numpy(SparcConfig(**dataclasses.asdict(mj.cfg)),
                               EBNO, params, "cpu")
    rng = np.random.default_rng(0)
    c = mj.cfg
    bits = rng.integers(0, 2, (B, c.k_bits)).astype(np.int32)
    noise = rng.standard_normal((B, c.n)).astype(np.float32)
    y = mj.encode(jnp.asarray(bits)) + noise * np.sqrt(mj.sigma2)
    return mj, mt, np.asarray(mj.op.embed_y(y)).reshape(B, L, M)


def _inputs(mode, L, M):
    """(y_n, mask, sq, P, n, T_run, f_b, m_b) of a case, NumPy."""
    mj, _, y_n = _models(L, M)
    c = mj.cfg
    f_b, m_b = FACTORS[(L, M)]
    if parse_mode(mode, L, M, c.n, f_b, m_b).base == "compact":
        mask = compact_mask(L, M, c.n).numpy()
    else:
        mask = np.asarray(mj.op.mask).reshape(L, M)
    T_run = T_ABLATED if _ablated(mode) else T
    return (y_n, mask, np.asarray(mj.sq_npl), c.P, c.n, T_run, f_b, m_b)


def _script_cases(path):
    """Run the BF16_CHAINS cases of the script in this process and save
    them to `path` (the subprocess entry point)."""
    out = {}
    for mode, (L, M) in CASES:
        if mode in BF16_CHAINS:
            b, t = run_script(mode, *_inputs(mode, L, M))
            out[f"{mode}_{L}_{M}_beta"], out[f"{mode}_{L}_{M}_trace"] = b, t
    np.savez(path, **out)


@functools.lru_cache(maxsize=None)
def _script_without_excess_precision():
    """The BF16_CHAINS cases of the script, run in a subprocess whose XLA
    rounds every bf16 operation."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cases.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false")
        code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
                "import test_torch_slab_experiments as t; "
                "t._script_cases(sys.argv[3])")
        subprocess.run([sys.executable, "-c", code, str(TESTS),
                        str(TESTS.parent), path], env=env, check=True,
                       timeout=600)
        with np.load(path) as f:
            return dict(f)


def check(mode, got, want, T_run):
    """The contract of `mode` (module docstring) on (beta, trace) pairs."""
    (bg, tg), (bw, tw) = got, want
    assert bg.shape == bw.shape and tg.shape == tw.shape
    assert tw.shape[0] == T_run
    if _ablated(mode):
        if mode == "no_consume":
            assert np.isnan(bg).all() and np.isnan(bw).all()
            return
        assert not np.isnan(bg).any() and not np.isnan(bw).any()
        scale = np.abs(bw).max()
        assert np.abs(bg - bw).max() <= 1e-2 * scale
        return
    assert np.isfinite(bg).all() and np.isfinite(tg).all()
    assert_decisions_match(bg, bw,
                           rel_margin=0.1 if mode == "bf16_radix" else 2e-2)
    if mode == "no_trace":
        assert not tg.any() and not tw.any()
    else:
        np.testing.assert_allclose(tg, tw, rtol=2e-2)


@pytest.mark.parametrize("mode,shape", CASES)
def test_plain_version_matches_the_script_kernel(mode, shape):
    """amp_slab_exp_reference against the script's Pallas kernel on the
    same draws, under the mode's contract."""
    L, M = shape
    y_n, mask, sq, P, n, T_run, f_b, m_b = _inputs(mode, L, M)
    if mode in BF16_CHAINS:
        cases = _script_without_excess_precision()
        want = (cases[f"{mode}_{L}_{M}_beta"], cases[f"{mode}_{L}_{M}_trace"])
    else:
        want = run_script(mode, y_n, mask, sq, P, n, T_run, f_b, m_b)
    beta, trace = amp_slab_exp_reference(
        mode, torch.tensor(y_n), torch.tensor(mask), torch.tensor(sq), P, n,
        T_run, f_b, m_b)
    check(mode, (beta.numpy(), trace.numpy()), want, T_run)


def test_every_mode_has_a_case():
    """Every variant the port names is held to the script above: each
    base mode, a factoring and a narrowed compact layout."""
    named = {parse_mode(m, *s, 2048, *FACTORS[s]).base for m, s in CASES}
    assert named >= {parse_mode(m, 1024, 512, 9216).base for m in MODES}
    assert any(m.startswith("f") for m, _ in CASES)
    assert any(m.startswith("compact") and m != "compact" for m, _ in CASES)
    assert set(DECODING) | set(ABLATED) == set(MODES)
    assert not set(DECODING) & set(ABLATED)


def test_pair_is_full_two_at_a_time():
    """The pair's beta is full's and its trace full's first codeword of
    each pair."""
    L, M = 256, 256
    y_n, mask, sq, P, n, _, f_b, m_b = _inputs("full", L, M)
    args = (torch.tensor(y_n), torch.tensor(mask), torch.tensor(sq), P, n, T,
            f_b, m_b)
    bp, tp = amp_slab_exp_reference("pair", *args)
    bf, tf = amp_slab_exp_reference("full", *args)
    torch.testing.assert_close(bp, bf, rtol=0, atol=0)
    torch.testing.assert_close(tp, tf[:, 0::2], rtol=0, atol=0)
    assert tp.shape == (T, B // 2)


def test_compact_mask_is_the_first_n_entries():
    m = compact_mask(1024, 512, 9216)
    assert m.shape == (1024, 512) and m.dtype == torch.float32
    assert float(m.sum()) == 9216
    assert bool((m[:18] == 1).all()) and not bool(m[18:].any())
    with pytest.raises(ValueError, match="exceeds"):
        compact_mask(4, 4, 17)


@pytest.mark.parametrize("mode,kw,match", [
    ("bogus", {}, "unknown mode"),
    ("f48m64", {}, "power of two"),
    ("f512m64", {}, "dividing 256"),
    ("f8m64", {}, ">= 16"),
    ("f64m128", {}, "dividing 64"),
    ("compact16", {}, r"\[24, 128\]"),
    ("compact40", {}, "multiple of 16"),
    ("pair", dict(Bn=3), "even"),
])
def test_amp_slab_exp_rejects_what_it_cannot_take(mode, kw, match):
    """Bad factorings, a compact csub below ceil(n / M) = 24 (n = 1536,
    M = 64) or off the 16-row tiles, and an odd batch for the pair."""
    L, M = 256, 64
    y = torch.zeros((kw.get("Bn", 2), L, M))
    with pytest.raises(ValueError, match=match):
        amp_slab_exp(mode, y, torch.ones((L, M)), torch.ones(L), 1.0, 1536,
                     2)


def test_cpu_route_is_the_plain_version():
    """On the CPU the wrapper is the kernels' plain version (K7's form,
    order="kernel") at the default factors (f_b = min(128, L), m_b =
    min(128, M)), and counts no kernel run."""
    L, M = 256, 64
    y_n, mask, sq, P, n, _, _, _ = _inputs("fold", L, M)
    args = (torch.tensor(y_n), torch.tensor(mask), torch.tensor(sq), P, n, 2)
    got = amp_slab_exp("fold", *args)
    want = amp_slab_exp_reference("fold", *args, 128, 64, order="kernel")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(amp_slab_exp.launches.values())


def _torch_inputs(mode, L, M):
    y_n, mask, sq, P, n, _, f_b, m_b = _inputs(mode, L, M)
    return (torch.tensor(y_n), torch.tensor(mask), torch.tensor(sq), P, n)


@pytest.mark.parametrize("mode", ["full", "pair", "sched", "fold_hfb",
                                  "bf16_radix"])
def test_resume_continues_the_decode(mode):
    """One iteration with its state kept, then two more from that state:
    the bits of three iterations in one run."""
    L, M = 256, 256
    f_b, m_b = FACTORS[(L, M)]
    args = _torch_inputs(mode, L, M)
    b3, t3 = amp_slab_exp_reference(mode, *args, 3, f_b, m_b)
    b1, t1, state = amp_slab_exp_reference(mode, *args, 1, f_b, m_b,
                                           keep_state=True)
    assert state.beta.shape == b1.shape and state.tau2.shape == (B,)
    br, tr = amp_slab_exp_reference(mode, *args, 2, f_b, m_b, state=state)
    assert torch.equal(br, b3)
    assert torch.equal(torch.cat([t1, tr]), t3)
    with pytest.raises(ValueError, match="compact"):
        amp_slab_exp_reference("compact", *_torch_inputs("compact", L, M), 1,
                               f_b, m_b, keep_state=True)


def _dense_transform(x, L, M):
    """H_L bf16(bf16(x) H_M) in float64 sums, the bf16 roundings of the
    script's transform, with the dense Sylvester matrices."""
    rb = lambda t: t.to(torch.float32).to(torch.bfloat16).to(torch.float64)
    hl = torch.tensor(np.asarray(hadamard_factor(L, jnp.float32)),
                      dtype=torch.float64)
    hm = torch.tensor(np.asarray(hadamard_factor(M, jnp.float32)),
                      dtype=torch.float64)
    return torch.matmul(hl, rb(torch.matmul(rb(x), hm)))


@pytest.mark.parametrize("shape", [(256, 256), (256, 64)])
def test_no_consume_from_a_decoded_state(shape):
    """no_consume's plain version from the state one full iteration
    leaves, against its arithmetic written out densely in float64 (z =
    H(beta), tau2 = |z|^2 / n, beta = (sq / tau2) (H(z) / sqrt(n) + beta)
    1e-3): finite, within 1e-2 of the scale."""
    L, M = shape
    f_b, m_b = FACTORS[shape]
    y_n, mask, sq, P, n = _torch_inputs("full", L, M)
    state = amp_slab_exp_reference("full", y_n, mask, sq, P, n, 1, f_b, m_b,
                                   keep_state=True)[2]
    got, trace = amp_slab_exp_reference("no_consume", y_n, mask, sq, P, n,
                                        T_ABLATED, f_b, m_b, state=state)
    b = state.beta.double()
    sq64 = sq.double().reshape(L, 1)
    for t in range(T_ABLATED):
        z = _dense_transform(b, L, M)
        tau2 = (z * z).sum((1, 2)) / n
        s = _dense_transform(z, L, M) / math.sqrt(n) + b
        b = (sq64 / tau2[:, None, None]) * s * 1e-3
        np.testing.assert_allclose(trace[t].numpy(), tau2.numpy(), rtol=1e-3)
    assert bool(torch.isfinite(got).all())
    scale = float(b.abs().max())
    assert float((got.double() - b).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("mode", ["full", "sched", "no_radix", "midbf16"])
def test_float64_sums_are_the_same_function(mode):
    """Given float64 tensors the plain version sums in float64 with the
    same bf16 roundings: the decode contract (or 1e-2 of the scale for the
    ablated variants) against its float32 self, dtypes kept."""
    L, M = 256, 256
    f_b, m_b = FACTORS[(L, M)]
    y_n, mask, sq, P, n = _torch_inputs(mode, L, M)
    T_run = T_ABLATED if _ablated(mode) else T
    b32, t32 = amp_slab_exp_reference(mode, y_n, mask, sq, P, n, T_run, f_b,
                                      m_b)
    b64, t64 = amp_slab_exp_reference(mode, y_n.double(), mask.double(),
                                      sq.double(), P, n, T_run, f_b, m_b)
    assert b64.dtype == t64.dtype == torch.float64
    check(mode, (b64.float().numpy(), t64.float().numpy()),
          (b32.numpy(), t32.numpy()), T_run)


# ------------------------------------------ the kernels' form (K7's)

@functools.lru_cache(maxsize=None)
def _port_case(L, M):
    """The port's own model of the script's code at (L, M) and one block
    of B encoded codewords on the CPU: (y_n, mask, sq, P, n)."""
    model = SparcModel.build(script_config(T, L, M), EBNO, "cpu")
    c = model.cfg
    y_n, _ = draw_block(model, torch.Generator().manual_seed(3), B)
    return y_n, model.op.mask.reshape(L, M), model.sq_npl, c.P, c.n


@pytest.mark.parametrize("shape", [(128, 128), (128, 64)])
def test_kernel_order_full_is_the_slab_form_reference(shape):
    """K7's form of full is K7's plain version, amp_fused_reference in
    the slab form at fixed T with y given, to float32 summation order
    where both round at the same places (L, M <= 128: one factor a
    transform stage): the same decisions, beta within 1e-5 of its scale,
    the trace to rtol 1e-5 (K7's form adds the adjoint's H_M over each
    row's entries in column order, the softmax's and |beta'|^2's sums in
    R3's lane order, and contracts the residual's multiply-adds)."""
    y_n, mask, sq, P, n = _port_case(*shape)
    want_b, want_t, _ = amp_fused_reference(y_n, mask, sq, P, n, T,
                                            form="slab")
    beta, trace = amp_slab_exp_reference("full", y_n, mask, sq, P, n, T,
                                         order="kernel")
    assert torch.equal(beta.argmax(-1), want_b.argmax(-1))
    scale = float(want_b.abs().max())
    assert float((beta - want_b).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(trace, want_t, rtol=1e-5, atol=0)


def test_kernel_order_pair_is_full():
    """In K7's form the pair's beta is full's and its trace full's first
    codeword of each pair; fold has nothing to fold and is full."""
    y_n, mask, sq, P, n = _port_case(256, 256)
    bf, tf = k7_form_reference("full", y_n, mask, sq, P, n, T)
    bp, tp = k7_form_reference("pair", y_n, mask, sq, P, n, T)
    assert torch.equal(bp, bf) and torch.equal(tp, tf[:, 0::2])
    assert tp.shape == (T, B // 2)
    bo, to = k7_form_reference("fold", y_n, mask, sq, P, n, T)
    assert torch.equal(bo, bf) and torch.equal(to, tf)


def test_kernel_order_traces_of_sched_and_no_trace():
    """sched's and fold_sched's traces are their fixed tau2, no_trace's
    is zero and its decode full's."""
    y_n, mask, sq, P, n = _port_case(256, 64)
    for mode in ("sched", "fold_sched"):
        _, trace = k7_form_reference(mode, y_n, mask, sq, P, n, T)
        assert torch.equal(trace, torch.full((T, B), SCHED_TAU2))
    bt, tt = k7_form_reference("no_trace", y_n, mask, sq, P, n, T)
    bf, _ = k7_form_reference("full", y_n, mask, sq, P, n, T)
    assert not bool(tt.any()) and torch.equal(bt, bf)


@pytest.mark.parametrize("mode", FACTORINGS)
def test_kernel_order_factorings_decide_as_full(mode):
    """Each factoring with a kernel computes full's function in K7's form:
    its decisions are full's under the bf16 decode contract, its trace
    full's to rtol 2e-2."""
    y_n, mask, sq, P, n = _port_case(256, 512)
    bf, tf = k7_form_reference("full", y_n, mask, sq, P, n, T)
    bm, tm = k7_form_reference(mode, y_n, mask, sq, P, n, T)
    assert bool(torch.isfinite(bm).all())
    assert_decisions_match(bm.numpy(), bf.numpy())
    np.testing.assert_allclose(tm.numpy(), tf.numpy(), rtol=2e-2)


@pytest.mark.parametrize("mode", ["full", "sched", "no_trace"])
def test_kernel_order_resume_continues_the_decode(mode):
    """In K7's form, one iteration with its state (beta') kept, then two
    more from that state: the bits of three iterations in one run."""
    y_n, mask, sq, P, n = _port_case(256, 256)
    args = (y_n, mask, sq, P, n)
    b3, t3 = k7_form_reference(mode, *args, 3)
    b1, t1, state = k7_form_reference(mode, *args, 1, keep_state=True)
    torch.testing.assert_close(state.beta * (1.0 / math.sqrt(n)), b1,
                               rtol=0, atol=0)
    br, tr = k7_form_reference(mode, *args, 2, state=state)
    assert torch.equal(br, b3)
    assert torch.equal(torch.cat([t1, tr]), t3)


@pytest.mark.parametrize("mode", ["full", "sched", "no_radix", "no_mm",
                                  "bf16_radix", "compact"])
def test_kernel_order_float64_sums_are_the_same_function(mode):
    """K7's form given float64 tensors sums in float64 with the same bf16
    roundings: the decode contract (or 1e-2 of the scale for the ablated
    variants, over T = 2) against its float32 self, dtypes kept."""
    L, M = 256, 256
    y_n, mask, sq, P, n = _port_case(L, M)
    if mode == "compact":
        mask = compact_mask(L, M, n)
    T_run = T_ABLATED if _ablated(mode) else T
    b32, t32 = k7_form_reference(mode, y_n, mask, sq, P, n, T_run)
    b64, t64 = k7_form_reference(mode, y_n.double(), mask.double(),
                                 sq.double(), P, n, T_run)
    assert b64.dtype == t64.dtype == torch.float64
    check(mode, (b64.float().numpy(), t64.float().numpy()),
          (b32.numpy(), t32.numpy()), T_run)


# --------------------------------------------------------------- the tool

def test_tool_runs_its_variants_on_the_cpu(capsys):
    """The tool's run function on a small CPU model (the plain versions):
    one record and one printed line per variant, in the script's format."""
    model = SparcModel.build(script_config(2, 256, 256), EBNO, "cpu")
    variants = list(DEFAULT_VARIANTS) + ["compact", "pair"]
    recs = slab_ablation.run(model, variants, B=2, T=2, reps=1)
    out = capsys.readouterr().out.splitlines()
    assert [r["mode"] for r in recs] == variants
    assert len(out) == len(variants)
    for rec, ln in zip(recs, out):
        assert ln.startswith(f"{rec['mode']:11s}: ")
        assert "ms/block" in ln and "us/iter/cw" in ln
        assert rec["ms"] > 0 and rec["us_per_iter_cw"] > 0


def test_tool_draws_noise_only_on_the_compact_support():
    """The script's draws: standard normal y, no codeword; the compact
    variants get the fabricated mask."""
    model = SparcModel.build(script_config(2, 256, 64), EBNO, "cpu")
    c = model.cfg
    y = slab_ablation.draw_noise(model, torch.Generator().manual_seed(0), 2)
    assert y.shape == (2, c.L, c.M) and bool((y != 0).all())
    assert torch.equal(slab_ablation.variant_mask(model, "compact32"),
                       compact_mask(c.L, c.M, c.n))
    assert torch.equal(slab_ablation.variant_mask(model, "full"),
                       model.op.mask.reshape(c.L, c.M))


def test_tool_needs_the_card_unless_told(monkeypatch):
    """Without a GPU and without --cpu the tool exits before it builds
    anything; an unknown variant is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        slab_ablation.main([])
    with pytest.raises(SystemExit):
        slab_ablation.main(["bogus", "--cpu"])
