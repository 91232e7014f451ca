"""The port's SparcModel (the whole decode slice) against the JAX reference
on the CPU, and the guards around it: the port imports no JAX and nothing
of the reference package, a CUDA request without CUDA raises, the
column-signed and DCT operators decode as the reference's, and
amp_kernel="fused" routes to the mono form at L <= 1024
and to the split form above, as in the reference.

Both packages get the same NumPy draws (torch and JAX random streams
differ), and each its own config class: the port's twin of a reference
config has the same fields and repr.  Contracts: exact for the design
constants; for decodes with bf16 transforms, margin-aware decisions
(tests/test_precision.py assert_decisions_match), equal trial and
iteration counts, tau2 to rtol 2e-2.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import SparcConfig as JSparcConfig
from sparc_ldpc_tpu.design import codebook as jcodebook
from sparc_ldpc_tpu.models.amp import amp_decode as j_amp_decode
from sparc_ldpc_tpu.models.sparc import SparcModel as JModel
from sparc_ldpc_tpu.utils.bits import np_bits_to_indices, np_indices_to_bits
from test_precision import assert_decisions_match
from test_torch_config import twin

import sparc_ldpc_tpu_torch as slt
from sparc_ldpc_tpu_torch.config import SparcConfig
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused, amp_fused_reference, fused_form)
from sparc_ldpc_tpu_torch.utils.rng import block_generator

EBNO = 4.0
# the headline configuration's options at a CPU-test size (the port's
# configs; J() gives the reference's twin)
FUSED = SparcConfig(L=64, M=128, R=1.0, power_alloc="iterative",
                    op_kind="hadamard", amp_kernel="fused_split",
                    transform_precision="bf16", amp_iters=16, amp_tol=0.0,
                    amp_iters_auto=True)
XLA = SparcConfig(L=64, M=128, R=1.0, power_alloc="iterative",
                  op_kind="hadamard", transform_precision="highest",
                  amp_iters=16, amp_tol=1e-4)


def J(cfg):
    """The reference's SparcConfig equal to the port's cfg."""
    return JSparcConfig(**dataclasses.asdict(cfg))


def _params(mj):
    """The reference model's constants as NumPy arrays."""
    mask = np.asarray(mj.op.mask)
    return dict(p_alloc=np.asarray(mj.p_alloc), sq_npl=np.asarray(mj.sq_npl),
                rows=np.flatnonzero(mask), mask=mask, sigma2=mj.sigma2,
                amp_iters=mj.cfg.amp_iters)


def _draws(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, cfg.k_bits)).astype(np.int32)
    noise = rng.standard_normal((B, cfg.n)).astype(np.float32)
    return bits, noise


def _counters(idx_true, idx_hat, logM):
    """The reference's counter definitions, in NumPy."""
    bits_true = np_indices_to_bits(idx_true, logM)
    bit_errors = (bits_true != np_indices_to_bits(idx_hat, logM)).sum(-1)
    return dict(bit_errors=int(bit_errors.sum()),
                frame_errors=int((bit_errors > 0).sum()),
                section_errors=int((idx_true != idx_hat).sum()))


# ---------------------------------------------------------- constants

@pytest.mark.parametrize("cfg", [FUSED, XLA, XLA.replace(tau_mode="se"),
                                 XLA.replace(power_alloc="flat")])
def test_build_constants_match_jax_exactly(cfg):
    mj = JModel.build(J(cfg), EBNO)
    mt = SparcModel.build(cfg, EBNO, "cpu")
    assert repr(mt.cfg) == repr(mj.cfg)          # incl. the SE-derived T
    assert mt.cfg == twin(mj.cfg)
    assert mt.sigma2 == mj.sigma2
    np.testing.assert_array_equal(mt.p_alloc, mj.p_alloc)
    np.testing.assert_array_equal(mt.sq_npl.numpy(), np.asarray(mj.sq_npl))
    np.testing.assert_array_equal(mt.op.mask.numpy(), np.asarray(mj.op.mask))
    if cfg.tau_mode == "se":
        np.testing.assert_array_equal(mt.tau2_schedule.numpy(),
                                      np.asarray(mj.tau2_schedule))
    else:
        assert mt.tau2_schedule is None


def test_from_numpy_takes_the_reference_constants():
    mj = JModel.build(J(FUSED), EBNO)
    mt = SparcModel.from_numpy(FUSED, EBNO, _params(mj), "cpu")
    mb = SparcModel.build(FUSED, EBNO, "cpu")
    assert mt.cfg == twin(mj.cfg)
    np.testing.assert_array_equal(mt.sq_npl.numpy(), np.asarray(mj.sq_npl))
    np.testing.assert_array_equal(mt.op.mask.numpy(), np.asarray(mj.op.mask))
    bits, noise = _draws(FUSED, 2)
    a, b = mt.run_block_from(bits, noise), mb.run_block_from(bits, noise)
    # the counters exactly; tau2_final, a float sum, to rtol 1e-5: CPU BLAS
    # (fwht_kron's tensordot) may sum in another order for buffers of
    # another alignment or with another thread count
    ints = [k for k in a if k != "tau2_final"]
    assert {k: a[k].item() for k in ints} == {k: b[k].item() for k in ints}
    np.testing.assert_allclose(a["tau2_final"].item(),
                               b["tau2_final"].item(), rtol=1e-5)
    bad = dict(_params(mj), rows=_params(mj)["rows"][1:])
    with pytest.raises(ValueError):
        SparcModel.from_numpy(FUSED, EBNO, bad, "cpu")


# ------------------------------------------------------------- slice

def test_run_block_from_matches_jax_in_kernel_encode_route():
    """The headline route: fused AMP with in-kernel encode, the noise drawn
    outside (the reference's CPU route, models/sparc.py:188-193)."""
    mj = JModel.build(J(FUSED), EBNO)
    mt = SparcModel.build(FUSED, EBNO, "cpu")
    c, B = mj.cfg, 4
    bits, noise = _draws(c, B)
    idx = np_bits_to_indices(bits, c.logM).astype(np.int32)
    y = noise * np.float32(math.sqrt(mj.sigma2))
    rj = j_amp_decode(jnp.asarray(y), mj.op, mj.sq_npl, c.P, c.n,
                      T=c.amp_iters, tol=c.amp_tol, fused=True,
                      fused_interpret=True, fused_split=True,
                      encode_idx=jnp.asarray(idx))
    launches = amp_fused.launches
    out = mt.run_block_from(bits, noise)
    assert amp_fused.launches == launches       # CPU: the plain version
    rt = mt.decode(torch.tensor(y), encode_idx=torch.tensor(idx))
    bj, bt = np.asarray(rj.beta), rt.beta.numpy()
    assert_decisions_match(bj, bt)
    ih_j, ih_t = bj.argmax(-1), bt.argmax(-1)
    want = _counters(idx, ih_t, c.logM)
    assert {k: out[k].item() for k in want} == want
    ref = _counters(idx, ih_j, c.logM)
    assert abs(want["section_errors"] - ref["section_errors"]) \
        <= int((ih_j != ih_t).sum())
    assert out["trials"].item() == B
    assert out["iters_sum"].item() == int(np.asarray(rj.iters).sum()) \
        == B * c.amp_iters
    np.testing.assert_allclose(out["tau2_final"].item(),
                               float(np.mean(np.asarray(rj.tau2_trace)[-1])),
                               rtol=2e-2)


def test_run_block_from_matches_jax_xla_route():
    """The scan route with the encode outside the decoder and early stop."""
    mj = JModel.build(J(XLA), EBNO)
    mt = SparcModel.build(XLA, EBNO, "cpu")
    c, B = mj.cfg, 3
    bits, noise = _draws(c, B, seed=1)
    x_j = np.asarray(mj.encode(jnp.asarray(bits)))
    x_t = mt.encode(torch.tensor(bits)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-5,
                               atol=1e-5 * np.abs(x_j).max())
    rj = mj.decode(jnp.asarray(x_j + noise * np.float32(math.sqrt(mj.sigma2))))
    out = mt.run_block_from(bits, noise)
    idx = np_bits_to_indices(bits, c.logM)
    want = _counters(idx, np.asarray(rj.beta).argmax(-1), c.logM)
    assert {k: out[k].item() for k in want} == want
    assert out["iters_sum"].item() == int(np.asarray(rj.iters).sum())
    assert out["iters_sum"].item() < B * c.amp_iters, "early stop unused"
    np.testing.assert_allclose(out["tau2_final"].item(),
                               float(np.mean(np.asarray(rj.tau2_trace)[-1])),
                               rtol=1e-4)


def test_encode_channel_decode_roundtrip_at_high_snr():
    mt = SparcModel.build(XLA, 8.0, "cpu")
    bits = torch.tensor(_draws(XLA, 2)[0])
    y = mt.channel(mt.encode(bits), block_generator(3, 0, 0))
    assert torch.equal(mt.decode_bits(y), bits)


def test_run_block_is_a_function_of_the_generator_seed():
    mt = SparcModel.build(FUSED, EBNO, "cpu")

    def run(block):
        out = mt.run_block(block_generator(5, 0, block), 3)
        return {k: v.item() for k, v in out.items()}

    first = run(0)
    assert first == run(0)
    assert first["trials"] == 3
    assert first["iters_sum"] == 3 * mt.cfg.amp_iters
    assert first["tau2_final"] != run(1)["tau2_final"]


# ------------------------------------------------------------- guards

def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import sparc_ldpc_tpu_torch as slt\n"
        "from sparc_ldpc_tpu_torch.models.sparc import SparcModel\n"
        "from sparc_ldpc_tpu_torch.utils.rng import block_generator\n"
        "cfg = slt.SparcConfig(L=32, M=64, R=1.0, amp_kernel='fused_split',\n"
        "                      amp_tol=0.0, amp_iters=6)\n"
        "m = SparcModel.build(cfg, 6.0, 'cpu')\n"
        "assert int(m.run_block(block_generator(0, 0, 0), 2)['trials']) == 2\n"
        "from sparc_ldpc_tpu_torch.models.concat import ConcatModel\n"
        "ccfg = slt.ConcatConfig(sparc=cfg, ldpc=slt.LdpcConfig(\n"
        "    kind='array', z=13, rows_b=3, cols_b=12, engine='qc',\n"
        "    schedule='layered', bp_iters=4), f_prot=0.9, feedback_iters=2)\n"
        "c = ConcatModel.build(ccfg, 6.0, 'cpu')\n"
        "assert int(c.run_block(block_generator(0, 0, 0), 2)['trials']) == 2\n"
        "import sparc_ldpc_tpu_torch.parallel.campaign\n"
        "from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, "
        "make_mesh\n"
        "pol = ShardingPolicy(make_mesh(2, ['cpu'] * 4))\n"
        "ms = SparcModel.build(cfg, 6.0, None, policy=pol)\n"
        "assert int(ms.run_block(block_generator(0, 0, 0), 2)['trials']) == 2\n"
        "import sparc_ldpc_tpu_torch.parallel.dist_fwht\n"
        "import sparc_ldpc_tpu_torch.tools.dryrun_multichip\n"
        "import sparc_ldpc_tpu_torch.ops.amp_slab_exp\n"
        "import sparc_ldpc_tpu_torch.tools.slab_ablation\n"
        "import sparc_ldpc_tpu_torch.utils.io\n"
        "import sparc_ldpc_tpu_torch.utils.profiling\n"
        "import sparc_ldpc_tpu_torch.utils.provenance\n"
        "from sparc_ldpc_tpu_torch import cli\n"
        "assert cli.main(['se', '--preset', 'plain_small']) == 0\n"
        "jax = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]\n"
        "assert not jax, jax\n"
        "ref = [k for k in sys.modules\n"
        "       if k == 'sparc_ldpc_tpu' or k.startswith('sparc_ldpc_tpu.')]\n"
        "assert not ref, ref\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=Path(__file__).resolve().parents[1],
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(RuntimeError):
        slt.default_device()
    with pytest.raises(RuntimeError):
        SparcModel.build(FUSED, EBNO, "cuda")
    with pytest.raises(RuntimeError):
        SparcModel.from_numpy(FUSED, EBNO,
                              _params(JModel.build(J(FUSED), EBNO)), "cuda")


@pytest.mark.parametrize("change", [
    dict(amp_kernel="fused_slab", amp_noise_in_kernel=True),
    dict(amp_kernel="fused_slab")])
def test_slab_configs_build_and_decode(change):
    """amp_kernel="fused_slab" builds and decodes on the slab form; the
    in-kernel noise stays the split form's, so with amp_noise_in_kernel
    the slab block draws torch.randn noise and encodes in the kernel, as
    the reference's gate has it (sparc_ldpc_tpu/models/sparc.py:176-180)."""
    m = SparcModel.build(FUSED.replace(**change), EBNO, "cpu")
    assert m.fused_kw == dict(fused_split=None, fused_form="slab")
    assert m.enc_in_kernel and not m.noise_in_kernel
    out = m.run_block(torch.Generator().manual_seed(0), 2)
    assert int(out["trials"]) == 2
    assert int(out["iters_sum"]) == 2 * m.cfg.amp_iters
    assert math.isfinite(float(out["tau2_final"]))


def _signed_params(mj):
    """The reference model's constants for an operator with column signs:
    its plan's rows and signs (the reference's design code, which its
    operator takes them from) and its transform size."""
    c = mj.cfg
    plan = (jcodebook.dct_plan(c.n, c.ML, c.op_seed, col_signs=True)
            if c.op_kind == "dct" else
            jcodebook.hadamard_plan(c.n, c.ML, c.op_seed, c.col_signs))
    return dict(p_alloc=np.asarray(mj.p_alloc), sq_npl=np.asarray(mj.sq_npl),
                rows=plan.rows, signs=plan.signs, N=mj.op.N,
                sigma2=mj.sigma2, amp_iters=mj.cfg.amp_iters)


def _jax_decode(mj, bits, noise):
    """The reference model's decode of the same draws (encode outside)."""
    x = np.asarray(mj.encode(jnp.asarray(bits)))
    return mj.decode(jnp.asarray(x + noise * np.float32(math.sqrt(
        mj.sigma2))))


@pytest.mark.parametrize("change", [dict(col_signs=True),
                                    dict(op_kind="dct")])
def test_unported_configs_raise_at_build(change):
    """The column-signed Hadamard operator and the DCT operator (once
    unported, ROADMAP A2 and A3) build and decode: the fused config takes
    the scan route with the encode and the noise outside (no mask), and a
    block's decisions agree with the reference's SparcModel on the same
    bits and noise, margin-aware, tau2 to rtol 1e-4.  The transforms run
    in float32: on the bf16 scan route the two packages' tau2 drift apart
    by up to 1 % over T, signs or none (rounding noise amplified)."""
    cfg = FUSED.replace(transform_precision="highest", **change)
    mt = SparcModel.build(cfg, EBNO, "cpu")
    mj = JModel.build(J(cfg), EBNO)
    assert mt.cfg == twin(mj.cfg)
    assert mt.op.mask is None and mj.op.mask is None
    assert not mt.enc_in_kernel and not mt.noise_in_kernel
    B = 3
    bits, noise = _draws(cfg, B, seed=4)
    launches = amp_fused.launches
    out = mt.run_block_from(bits, noise)
    assert amp_fused.launches == launches
    rt = mt.decode(mt.encode(torch.tensor(bits))
                   + torch.tensor(noise) * math.sqrt(mt.sigma2))
    rj = _jax_decode(mj, bits, noise)
    assert_decisions_match(np.asarray(rj.beta), rt.beta.numpy())
    idx = np_bits_to_indices(bits, cfg.logM)
    want = _counters(idx, rt.beta.numpy().argmax(-1), cfg.logM)
    assert {k: out[k].item() for k in want} == want
    assert out["trials"].item() == B
    np.testing.assert_allclose(out["tau2_final"].item(),
                               float(np.mean(np.asarray(rj.tau2_trace)[-1])),
                               rtol=1e-4)
    assert out["iters_sum"].item() == int(np.asarray(rj.iters).sum())


@pytest.mark.parametrize("change", [dict(col_signs=True),
                                    dict(op_kind="dct")])
def test_from_numpy_carries_signs_and_dct_plans(change):
    """from_numpy takes the rows and the column signs of the reference's
    plan (and its transform size): the model decodes as the reference's on
    the same draws, and as the port's own build does."""
    cfg = FUSED.replace(transform_precision="highest", **change)
    mj = JModel.build(J(cfg), EBNO)
    params = _signed_params(mj)
    mt = SparcModel.from_numpy(cfg, EBNO, params, "cpu")
    mb = SparcModel.build(cfg, EBNO, "cpu")
    assert (mt.op.n, mt.op.ML, mt.op.N) == (mj.op.n, mj.op.ML, mj.op.N)
    bits, noise = _draws(cfg, 2, seed=5)
    a, b = mt.run_block_from(bits, noise), mb.run_block_from(bits, noise)
    ints = [k for k in a if k != "tau2_final"]
    assert {k: a[k].item() for k in ints} == {k: b[k].item() for k in ints}
    rt = mt.decode(mt.encode(torch.tensor(bits))
                   + torch.tensor(noise) * math.sqrt(mt.sigma2))
    rj = _jax_decode(mj, bits, noise)
    assert_decisions_match(np.asarray(rj.beta), rt.beta.numpy())
    np.testing.assert_allclose(
        rt.tau2_trace[-1].numpy(), np.asarray(rj.tau2_trace)[-1], rtol=1e-4)
    # the signs are the model's: other signs make another operator
    flipped = dict(params, signs=-params["signs"])
    mf = SparcModel.from_numpy(cfg, EBNO, flipped, "cpu")
    beta = torch.randn(1, cfg.ML, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(mf.op.Ax(beta), mt.op.Ax(-beta))


@pytest.mark.parametrize("kernel,L,form", [
    ("fused", 64, "mono"), ("fused", 2048, "split"),
    ("fused_split", 64, "split")])
def test_fused_kernel_choice_routes_as_the_reference(kernel, L, form):
    """amp_kernel="fused" reaches the mono form at L <= 1024 and the split
    form above it; "fused_split" forces the split form: the model's decode
    is the plain version of that form, bit for bit."""
    cfg = SparcConfig(L=L, M=32, R=1.0, op_kind="hadamard",
                      amp_kernel=kernel, amp_iters=4, amp_tol=0.0)
    mt = SparcModel.build(cfg, 6.0, "cpu")
    assert mt.fused and fused_form(L, mt.fused_kw["fused_split"]) == form
    bits, noise = _draws(cfg, 2, seed=3)
    y = torch.tensor(noise) * math.sqrt(mt.sigma2)
    idx = torch.tensor(np_bits_to_indices(bits, cfg.logM), dtype=torch.int32)
    got = mt.decode(y, encode_idx=idx)
    y_n = mt.op.embed_y(y).reshape(2, L, cfg.M)
    want = amp_fused_reference(y_n, mt.op.mask.reshape(L, cfg.M), mt.sq_npl,
                               cfg.P, cfg.n, 4, encode_idx=idx, form=form)
    assert torch.equal(got.beta, want[0])
    assert torch.equal(got.tau2_trace, want[1])
    if form == "mono":
        split = amp_fused_reference(y_n, mt.op.mask.reshape(L, cfg.M),
                                    mt.sq_npl, cfg.P, cfg.n, 4,
                                    encode_idx=idx, form="split")
        assert not torch.equal(got.beta, split[0])


def test_fast_l4096_shaped_config_runs_the_noise_route():
    """PRESETS["fast_l4096"] cut to L=2048, M=32 (R=1.5, iterative power,
    tol 1e-4, the noise drawn in the kernel): "fused" takes the split
    form with the in-kernel noise, and run_block gives the same counters
    for the same generator seed."""
    cfg = slt.PRESETS["fast_l4096"].replace(L=2048, M=32)
    mt = SparcModel.build(cfg, 6.5, "cpu")
    assert mt.noise_in_kernel and mt.enc_in_kernel
    assert fused_form(cfg.L) == "split"

    def run(block):
        out = mt.run_block(block_generator(7, 0, block), 2)
        return {k: v.item() for k, v in out.items()}

    first = run(0)
    assert first == run(0)
    assert first["trials"] == 2
    assert 2 <= first["iters_sum"] <= 2 * cfg.amp_iters
    assert first != run(1)


def test_in_kernel_noise_is_not_ported():
    """Ported since: with amp_noise_in_kernel the block draws one Philox
    key per codeword after the bits, and the fused route draws the noise
    from it; the same generator gives the same counters."""
    mt = SparcModel.build(FUSED.replace(amp_noise_in_kernel=True), EBNO,
                          "cpu")
    assert mt.noise_in_kernel
    out = {k: v.item() for k, v in
           mt.run_block(block_generator(0, 0, 0), 3).items()}
    gen = block_generator(0, 0, 0)
    bits = torch.randint(0, 2, (3, FUSED.k_bits), generator=gen,
                         dtype=torch.int32)
    seeds = mt.draw_seeds(gen, 3)
    want = mt._block(bits, None, seeds)
    assert out == {k: v.item() for k, v in want.items()}
    assert out == {k: v.item() for k, v in
                   mt.run_block(block_generator(0, 0, 0), 3).items()}
    assert out["trials"] == 3


def test_noise_route_gate_is_the_reference_gate():
    on = FUSED.replace(amp_noise_in_kernel=True)
    assert SparcModel.build(on, EBNO, "cpu").noise_in_kernel
    for cfg in (FUSED, on.replace(amp_encode_in_kernel=False),
                XLA.replace(amp_noise_in_kernel=True)):
        assert not SparcModel.build(cfg, EBNO, "cpu").noise_in_kernel
    # the --pallas operator has no row mask: scan route, XLA-side noise
    assert not SparcModel.build(on, EBNO, "cpu",
                                use_pallas=True).noise_in_kernel


def test_noise_route_decodes_without_errors_at_high_snr():
    mt = SparcModel.build(FUSED.replace(amp_noise_in_kernel=True), 8.0,
                          "cpu")
    out = mt.run_block(block_generator(3, 0, 0), 4)
    assert out["trials"].item() == 4
    assert out["section_errors"].item() == 0
    assert out["bit_errors"].item() == 0
    # the decoder's final tau2 sits at the noise level it was given
    assert abs(out["tau2_final"].item() / mt.sigma2 - 1) < 0.2
