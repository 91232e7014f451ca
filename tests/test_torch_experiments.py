"""The port of the split AMP kernel's experiments (ops/amp_exp.py and the
tools kernel_ablation, lstage_exp and pair_kernel_exp) against the
reference's own TPU kernels: scripts/kernel_ablation.py `make_kernel`
(S2), scripts/lstage_exp.py `make_kernel` (S3) and scripts/pair_kernel_exp.py
`_amp_kernel_split_pair` (S1), loaded from the scripts unchanged and run in
Pallas interpret mode on the CPU with the test's own pallas_call (as
tests/test_precision.py runs K1).

Both sides get the same NumPy draws, encoded by the reference's SparcModel;
the port's model takes the reference's constants (SparcModel.from_numpy).
Contracts: the decoding variants (full, every S3 variant, pair) the bf16
decode contract, margin-aware decisions (test_precision.py
assert_decisions_match) and the tau2 trace to rtol 2e-2 over T = 3; the
ablated S2 variants (garbage decodes: no_max can overflow to NaN) over
T = 2, beta within 1e-2 of the script's largest finite |beta| with NaN
where the script has NaN.  The plain versions round where the scripts
round, so they differ from them in summation order only: after one
iteration beta agrees to float32 rounding.  At the scripts' 2.0 dB each
iteration in the middle of the decode amplifies a bf16 rounding that the
summation order moved by one ulp, so by the fourth iteration near-tie
sections of these small blocks flip beyond the contract's 1 % (and at
L = 1024 some with margins above 2 %), where after three they stay
within it.  Three iterations run every line of the iteration (the
Onsager term from the second on).
The plain version the card's S2 kernels are held to in bf16 (order=
"kernel") is K1's scale-free form in K1's float32 arithmetic: it is held
here to a float64 decode with the same rounding points, to the scripts'
function in float32, and (full) to the script's kernel.
"""

import dataclasses
import functools
import importlib.util
import math
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
from sparc_ldpc_tpu_torch.ops.amp_exp import (
    ABLATED, MODES, S1_MODES, S2_MODES, S3_MODES, amp_exp, amp_exp_reference,
    mode_f_b)
from sparc_ldpc_tpu_torch.tools import kernel_ablation, lstage_exp
from sparc_ldpc_tpu_torch.tools import pair_kernel_exp

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
EBNO = 2.0
B, T, T_ABLATED = 2, 3, 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_exp_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _kernels():
    return (_script("kernel_ablation"), _script("lstage_exp"),
            _script("pair_kernel_exp"))


def run_script(mode, y_n, mask, sq, P, n, T, f_b):
    """The script's kernel of `mode` on y_n (B, L, M) in interpret mode:
    (beta, trace (T, B or B / 2))."""
    ablation, lstage, pair = _kernels()
    Bn, L, M = y_n.shape
    f_a = L // f_b
    C = 2 if mode in S1_MODES else 1
    args = (T, n, float(P), 1.0 / math.sqrt(n), f_a, f_b)
    if mode in S1_MODES:
        kernel = functools.partial(pair._amp_kernel_split_pair, *args)
    else:
        kernel = (ablation if mode in S2_MODES else lstage).make_kernel(
            mode, *args)
    hm = hadamard_factor(128 if mode == "l256_m128" else M, jnp.bfloat16)
    tile = (C, L, M)
    beta, trace = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((Bn, L, M), jnp.float32),
                   jax.ShapeDtypeStruct((Bn // C, 8, 128), jnp.float32)),
        grid=(Bn // C,),
        in_specs=[
            pl.BlockSpec(tile, lambda b: (b, 0, 0)),
            pl.BlockSpec((L, M), lambda b: (0, 0)),
            pl.BlockSpec((f_a, f_a), lambda b: (0, 0)),
            pl.BlockSpec((f_b, f_b), lambda b: (0, 0)),
            pl.BlockSpec(hm.shape, lambda b: (0, 0)),
            pl.BlockSpec((L, 1), lambda b: (0, 0)),
        ],
        out_specs=(pl.BlockSpec(tile, lambda b: (b, 0, 0)),
                   pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0))),
        scratch_shapes=[pltpu.VMEM(tile if C > 1 else (L, M),
                                   jnp.float32)] * 3,
        interpret=True,
    )(jnp.asarray(y_n), jnp.asarray(mask).astype(jnp.bfloat16),
      hadamard_factor(f_a, jnp.bfloat16), hadamard_factor(f_b, jnp.bfloat16),
      hm, jnp.asarray(sq).reshape(L, 1))
    return (np.asarray(beta),
            np.asarray(trace).reshape(Bn // C, -1)[:, :T].T)


def _cfg(L, M):
    return JSparcConfig(L=L, M=M, R=1.0, power_alloc="iterative",
                        op_kind="hadamard", amp_iters=T, amp_tol=0.0,
                        transform_precision="bf16")


@functools.lru_cache(maxsize=None)
def _models(L, M):
    """The reference model at (L, M), the port's twin on its constants
    (SparcModel.from_numpy), and one block's draws: (mj, mt, y_n (B, L, M)
    NumPy, true section indices (B, L))."""
    mj = JModel.build(_cfg(L, M), EBNO)
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
    y_n = np.asarray(mj.op.embed_y(y)).reshape(B, L, M)
    idx = (bits.reshape(B, L, c.logM)
           * (1 << np.arange(c.logM - 1, -1, -1))).sum(-1)
    return mj, mt, y_n, idx


def _shape(mode):
    return (256, 512) if mode == "l256_m128" else (256, 64)


def check(mode, got, want, T_run):
    """The contract of `mode` (module docstring) on (beta, trace) pairs."""
    (bg, tg), (bw, tw) = got, want
    assert bg.shape == bw.shape and tg.shape == tw.shape == (T_run,
                                                            tw.shape[1])
    if mode in ABLATED:
        nan_g, nan_w = np.isnan(bg), np.isnan(bw)
        np.testing.assert_array_equal(nan_g, nan_w)
        fin = ~nan_w
        scale = np.abs(bw[fin]).max()
        assert np.abs(bg[fin] - bw[fin]).max() <= 1e-2 * scale
    else:
        assert np.isfinite(bg).all() and np.isfinite(tg).all()
        assert_decisions_match(bg, bw)
        np.testing.assert_allclose(tg, tw, rtol=2e-2)


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_the_script_kernel(mode):
    """amp_exp_reference against the script's Pallas kernel on the same
    draws: S2's modes and the pair at (256, 64) with f_b = 128, S3's with
    the mode's radix factor (f_b = L / f_a), l256_m128 at (256, 512)."""
    L, M = _shape(mode)
    mj, mt, y_n, _ = _models(L, M)
    f_b = 128 if mode in S2_MODES + S1_MODES else mode_f_b(mode, L)
    T_run = T_ABLATED if mode in ABLATED else T
    c = mj.cfg
    want = run_script(mode, y_n, np.asarray(mj.op.mask).reshape(L, M),
                      np.asarray(mj.sq_npl), c.P, c.n, T_run, f_b)
    beta, trace = amp_exp_reference(
        mode, torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl, c.P,
        c.n, T_run, f_b, mode in S1_MODES)
    check(mode, (beta.numpy(), trace.numpy()), want, T_run)


def test_pair_trace_is_the_first_codeword_of_each_pair():
    L, M = _shape("pair")
    _, mt, y_n, _ = _models(L, M)
    c = mt.cfg
    args = (torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl, c.P,
            c.n, T)
    bp, tp = amp_exp_reference("pair", *args, pair=True)
    bf, tf = amp_exp_reference("full", *args)
    torch.testing.assert_close(bp, bf, rtol=0, atol=0)
    torch.testing.assert_close(tp, tf[:, 0::2], rtol=0, atol=0)


def test_float32_plain_version_is_the_unrounded_decode():
    """precision="highest" rounds nothing: every S3 factoring is then the
    same H_L up to summation order, so its decode is S2's full decode."""
    L, M = _shape("full")
    _, mt, y_n, _ = _models(L, M)
    c = mt.cfg
    args = (torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl, c.P,
            c.n, T)
    bf, tf = amp_exp_reference("full", *args, precision="highest")
    for mode in ("slab_loop", "f512_vpu2", "f128_vpu8"):
        b, t = amp_exp_reference(mode, *args, f_b=mode_f_b(mode, L),
                                 precision="highest")
        torch.testing.assert_close(t, tf, rtol=1e-5, atol=0)
        torch.testing.assert_close(b, bf, rtol=1e-4, atol=1e-4 * float(
            bf.abs().max()))


def kernel_order_numpy(mode, y_n, mask, sq, P, n, T):
    """The decode of an S2 mode or the pair rounded where its kernel rounds
    (forward H_L rnd(H_M rnd(beta')), adjoint H_M rnd(H_L rnd(z)), H_L the
    identity for m_stage_only and no_transform, H_M for no_transform; the
    kernels are K1's, which hold and round beta' = beta sqrt(n)), in
    float64 NumPy with dense Hadamard matrices: (beta, trace (T, B or
    B / 2))."""
    from scipy.linalg import hadamard

    def rnd(x):
        t = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)
        return t.to(torch.float64).numpy()

    Bn, L, M = y_n.shape
    hl, hm = hadamard(L).astype(np.float64), hadamard(M).astype(np.float64)
    if mode in ("m_stage_only", "no_transform"):
        hl = np.eye(L)
    if mode == "no_transform":
        hm = np.eye(M)
    s = np.sqrt(n)

    def fwd(b):
        return hl @ rnd(rnd(b * s) @ hm) / s

    def adj(z):
        return rnd(hl @ rnd(z)) @ hm

    y = y_n.astype(np.float64)
    sq = sq.astype(np.float64).reshape(L, 1)
    beta, z = np.zeros_like(y), np.zeros_like(y)
    trace, tau2_prev = np.zeros((T, Bn)), None
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(T):
            if mode == "no_norms":
                coef = np.full(Bn, 0.1)
            elif t == 0:
                coef = np.zeros(Bn)
            else:
                coef = (P - (beta * beta).sum((1, 2)) / n) / tau2_prev
            z = mask * (y - fwd(beta) / np.sqrt(n)) + coef[:, None, None] * z
            tau2 = (np.full(Bn, 0.5) if mode == "no_norms"
                    else (z * z).sum((1, 2)) / n)
            s_ = adj(z) / np.sqrt(n) + beta
            ai = sq / tau2[:, None, None]
            if mode == "no_softmax":
                beta = s_ * ai * 1e-3
            else:
                a = ai * s_
                if mode != "no_max":
                    a = a - a.max(-1, keepdims=True)
                e = np.exp(a)
                beta = (sq / e.sum(-1, keepdims=True)) * e
            trace[t], tau2_prev = tau2, tau2
    return beta, (trace[:, 0::2] if mode in S1_MODES else trace)


@pytest.mark.parametrize("mode", S2_MODES + S1_MODES)
def test_kernel_order_plain_version_rounds_where_the_kernels_round(mode):
    """amp_exp_reference(order="kernel"), what the card's K1-style variants
    are held to in bf16, against a float64 NumPy decode with the same
    rounding points, under the mode's contract at (256, 64)."""
    L, M = _shape(mode)
    _, mt, y_n, _ = _models(L, M)
    c = mt.cfg
    T_run = T_ABLATED if mode in ABLATED else T
    mask, sq = mt.op.mask.reshape(L, M), mt.sq_npl
    beta, trace = amp_exp_reference(
        mode, torch.tensor(y_n), mask, sq, c.P, c.n, T_run, 128,
        mode in S1_MODES, order="kernel")
    want = kernel_order_numpy(mode, y_n, mask.numpy(), sq.numpy(), c.P,
                              c.n, T_run)
    check(mode, (beta.numpy(), trace.numpy()), want, T_run)


@pytest.mark.parametrize("mode", S2_MODES)
def test_kernel_order_is_the_script_function_in_float32(mode):
    """S2's kernel order is K1's scale-free form (beta' = beta sqrt(n),
    mask / n, sq / sqrt(n), sq sqrt(n)): rounding nothing, it computes the
    scripts' function, to float32 rounding, with NaN (no_max's overflow)
    where the scripts' form has NaN."""
    L, M = _shape(mode)
    _, mt, y_n, _ = _models(L, M)
    c = mt.cfg
    T_run = T_ABLATED if mode in ABLATED else T
    args = (mode, torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl,
            c.P, c.n, T_run, 128)
    bk, tk = amp_exp_reference(*args, precision="highest", order="kernel")
    bs, ts = amp_exp_reference(*args, precision="highest", order="script")
    nan = torch.isnan(bs)
    assert torch.equal(torch.isnan(bk), nan)
    torch.testing.assert_close(tk, ts, rtol=1e-5, atol=0, equal_nan=True)
    scale = float(bs[~nan].abs().max())
    assert float((bk - bs)[~nan].abs().max()) <= 1e-5 * scale


def test_kernel_order_pair_is_k1_full():
    """The pair's kernels are K1's (its row stage paired): in the kernel
    order its beta is K1's form of full bit for bit, its trace full's of
    the first codeword of each pair, in bf16 and in float32."""
    L, M = _shape("pair")
    _, mt, y_n, _ = _models(L, M)
    c = mt.cfg
    args = (torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl, c.P,
            c.n, T, 128)
    for prec in ("bf16", "highest"):
        bp, tp = amp_exp_reference("pair", *args, True, prec, "kernel")
        bf, tf = amp_exp_reference("full", *args, False, prec, "kernel")
        assert torch.equal(bp, bf) and torch.equal(tp, tf[:, 0::2])
        assert tp.shape == (T, B // 2)


def test_kernel_order_full_decodes_as_the_script_kernel():
    """full as its kernel computes it (K1's scale-free form and rounding
    points, order="kernel") against the script's Pallas kernel on the same
    draws, under the bf16 decode contract."""
    L, M = _shape("full")
    mj, mt, y_n, _ = _models(L, M)
    c = mj.cfg
    want = run_script("full", y_n, np.asarray(mj.op.mask).reshape(L, M),
                      np.asarray(mj.sq_npl), c.P, c.n, T, 128)
    beta, trace = amp_exp_reference(
        "full", torch.tensor(y_n), mt.op.mask.reshape(L, M), mt.sq_npl, c.P,
        c.n, T, 128, order="kernel")
    check("full", (beta.numpy(), trace.numpy()), want, T)


def test_kernel_order_is_refused_for_the_s3_variants():
    y = torch.zeros((2, 256, 64))
    with pytest.raises(ValueError, match="K1-style"):
        amp_exp_reference("slab_loop", y, torch.ones((256, 64)),
                          torch.ones(256), 1.0, 1536, 2, 32, order="kernel")


@pytest.mark.parametrize("kw,match", [
    (dict(mode="bogus"), "unknown mode"),
    (dict(mode="l256_m128"), "M must be 512"),
    (dict(mode="pair", B=3), "even B"),
    (dict(mode="slab_loop", precision="highest"), "bf16"),
])
def test_amp_exp_rejects_what_it_cannot_take(kw, match):
    L, M = 256, 64
    Bn = kw.pop("B", 2)
    y = torch.zeros((Bn, L, M))
    with pytest.raises(ValueError, match=match):
        amp_exp(kw.pop("mode"), y, torch.ones((L, M)), torch.ones(L), 1.0,
                1536, 2, **kw)


# --------------------------------------------------------------- tools

@pytest.mark.parametrize("tool,variants,decodes", [
    (kernel_ablation, S2_MODES, False),
    (lstage_exp, S3_MODES, True),
    (pair_kernel_exp, pair_kernel_exp.VARIANTS, True),
])
def test_tool_runs_its_variants_on_the_cpu(tool, variants, decodes, capsys):
    """Each tool's run function on a small CPU model (the plain versions):
    one record and one printed line per variant, numbers finite."""
    model = SparcModel.build(kernel_ablation.script_config(2, 256, 512),
                             EBNO, "cpu")
    recs = kernel_ablation.run(model, variants, B=2, T=2, decodes=decodes,
                               reps=1)
    out = capsys.readouterr().out.splitlines()
    assert [r["mode"] for r in recs] == list(variants)
    assert len(out) == len(variants)
    for rec, ln in zip(recs, out):
        assert ln.startswith(rec["mode"]) and "ms/block" in ln
        assert ("sec_err=" in ln) == decodes
        assert rec["ms"] > 0 and 0 <= rec["sec_err"] <= 2 * 256
        if rec["mode"] not in ABLATED:
            assert math.isfinite(rec["tau2_final"])


@pytest.mark.parametrize("tool", [kernel_ablation, lstage_exp,
                                  pair_kernel_exp])
def test_tool_needs_the_card_unless_told(tool, monkeypatch):
    """Without a GPU and without --cpu a tool exits before it builds
    anything; an unknown variant is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        tool.main([])
    with pytest.raises(SystemExit):
        tool.main(["bogus", "--cpu"])


def test_ablation_tool_full_is_the_script_kernel_on_the_reference_model():
    """The slice end to end at the scripts' shape (L=1024, M=512): the S2
    tool's full decode on the port's model, built from the reference
    model's constants, against the script's kernel on the reference
    model, on the same draws."""
    L, M = 1024, 512
    mj, mt, y_n, idx = _models(L, M)
    c = mj.cfg
    want = run_script("full", y_n, np.asarray(mj.op.mask).reshape(L, M),
                      np.asarray(mj.sq_npl), c.P, c.n, T, 128)
    beta, trace = kernel_ablation.decode(mt, "full", torch.tensor(y_n), T)
    check("full", (beta.numpy(), trace.numpy()), want, T)
    # the decode is under way: guessing would miss 511 sections of 512
    assert (beta.numpy().argmax(-1) != idx).mean() < 0.6
