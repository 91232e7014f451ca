"""The reference's frozen copies against the port's functions, at small
sizes on the CPU (the tests may import both; the reference may not)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import sparc_ldpc_tpu_torch as slt
from benchmark.harness import spec
from benchmark.reference import amp, codes, design, ldpc, noise, seeds
from benchmark.tests.tiny import TINY_QC, write_qc
from sparc_ldpc_tpu_torch.design.ldpc_codes import build_code
from sparc_ldpc_tpu_torch.models.concat import ConcatModel, _derive_partition
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import (
    amp_fused_reference, channel_noise_reference)
from sparc_ldpc_tpu_torch.utils.rng import block_seed

SMALL = dict(L=64, M=64, R=1.0, power_alloc="iterative", op_kind="hadamard",
             amp_kernel="fused_split", transform_precision="bf16",
             amp_iters=32, amp_tol=0.0, amp_iters_auto=True,
             amp_noise_in_kernel=True)
LDPC = dict(kind="array", z=7, rows_b=3, cols_b=8, engine="qc",
            schedule="layered", bp_iters=32)


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def config_file(name):
    return spec._json(spec.PKG_DIR / "configs" / f"{name}.json")


def small_concat():
    sp = slt.SparcConfig(**dict(SMALL, amp_tol=1e-4, amp_iters_auto=False))
    return slt.ConcatConfig(sparc=sp, ldpc=slt.LdpcConfig(**LDPC),
                            f_prot=0.5)


@pytest.mark.parametrize("coords", [(0, 0, 0), (1234, 3, 17),
                                    (2 ** 31 + 77, 0, 5), (2 ** 40, 9, 1)])
def test_block_seed_is_the_ports(coords):
    assert seeds.block_seed(*coords) == block_seed(*coords)


@pytest.mark.parametrize("kind", ["sparc", "concat"])
def test_block_draws_follow_the_ports_draw_order(kind):
    """The bits and noise keys the port's run_block decodes are the
    reference's draws of the same block."""
    if kind == "sparc":
        model = SparcModel.build(slt.SparcConfig(**SMALL), 3.0, "cpu")
        target, bits = model, model.cfg.k_bits
    else:
        model = ConcatModel.build(small_concat(), 3.0, "cpu")
        target, bits = model, model.k_user
    seen = {}
    orig = target._block

    def spy(b, noise_in, *rest):
        # the noise keys come last (sparc: sq_npl and sigma before them)
        seen.update(bits=b, keys=rest[-1])
        return orig(b, noise_in, *rest)

    object.__setattr__(target, "_block", spy)
    from sparc_ldpc_tpu_torch.utils.rng import block_generator
    target.run_block(block_generator(99, 2, 5, "cpu"), 8)
    ref_bits, ref_keys = seeds.block_draws(99, 2, 5, 8, bits, "cpu")
    assert torch.equal(seen["bits"], ref_bits)
    assert torch.equal(seen["keys"], ref_keys)


@pytest.mark.parametrize("L,M", [(64, 64), (32, 128)])
def test_noise_is_the_kernels_arithmetic(L, M):
    g = torch.Generator().manual_seed(L + M)
    keys = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=g,
                         dtype=torch.int32)
    mask = (torch.rand((L, M), generator=g) < 0.3).to(torch.float32)
    assert torch.equal(noise.channel_noise(keys, mask, 0.61),
                       channel_noise_reference(keys, mask, 0.61))


@pytest.mark.parametrize("ebno", [2.0, 4.0])
def test_design_is_the_ports(ebno):
    cfg = slt.SparcConfig(**SMALL)
    model = SparcModel.build(cfg, ebno, "cpu")
    d = as_dict(cfg)
    s2 = design.sigma2(d, ebno)
    assert s2 == pytest.approx(cfg.sigma2(ebno), rel=1e-15)
    p = design.power(d, s2)
    np.testing.assert_array_equal(p, model.p_alloc)
    assert design.iterations(d, p, s2) == model.cfg.amp_iters
    assert torch.equal(torch.as_tensor(design.row_mask(d)).reshape(-1),
                       model.op.mask)


def test_amp_in_float32_is_the_ports_function():
    """Unrounded, the reference's AMP and the port's plain version of K1
    compute one function (summation order apart)."""
    cfg = slt.SparcConfig(**dict(SMALL, amp_tol=1e-4, amp_iters_auto=False))
    model = SparcModel.build(cfg, 3.0, "cpu")
    ref = codes.Sparc(as_dict(cfg), 3.0, "cpu", "float32")
    bits, keys = seeds.block_draws(5, 0, 0, 6, ref.message_bits, "cpu")
    idx = codes.to_indices(bits, ref.logM)
    pin = torch.where(torch.rand(idx.shape) < 0.2, idx, -1).to(torch.int32)
    for p in (None, pin):
        mine = ref.amp(idx, keys, T=12, pin=p)
        beta, trace, iters = amp_fused_reference(
            None, model.op.mask.reshape(64, 64), model.sq_npl, 1.0, ref.n,
            12, encode_idx=idx.to(torch.int32), precision="highest",
            tol=1e-4, pin_idx=p, noise_seed=keys,
            noise_sigma=math.sqrt(ref.s2), split=True)
        assert torch.equal(mine["iters"], iters)
        assert torch.equal(mine["beta"].argmax(-1), beta.argmax(-1))
        scale = math.sqrt(ref.n)
        np.testing.assert_allclose(mine["beta"] / scale, beta, atol=1e-4)
        np.testing.assert_allclose(mine["tau2"], trace[-1], rtol=1e-5)


def test_rounding_kinds():
    x = torch.tensor([[1.0, 1.0 + 2 ** -9, 3.0, 300.0]])
    assert torch.equal(amp.rounder("float32")(x), x)
    assert amp.rounder("bf16")(x)[0, 1] == 1.0
    y = amp.rounder("fp8")(x)
    assert y[0, 3] == 300.0 and y[0, 2] != 3.0 or y[0, 2] == 3.0
    assert torch.all((y - x).abs() <= x.abs() * 2 ** -3 + 1e-6)
    with pytest.raises(ValueError):
        amp.rounder("int4")


def ldpc_case(name, tmp_path):
    """(the port's LdpcConfig, the reference's dict) of a test code."""
    if name == "array7":
        cfg = slt.LdpcConfig(**LDPC)
        return cfg, as_dict(cfg)
    if name == "tiny_qc":
        Z, shifts = TINY_QC
        write_qc(tmp_path / "tiny.qc", Z, shifts)
        cfg = slt.LdpcConfig(kind="qc", path=str(tmp_path / "tiny.qc"),
                             engine="qc", schedule="layered", bp_iters=32)
        return cfg, dict(as_dict(cfg), qc_base=dict(Z=Z, shifts=shifts))
    d = config_file("concat_wifi")["ldpc"]
    names = {f.name for f in dataclasses.fields(slt.LdpcConfig)}
    return slt.LdpcConfig(**{k: v for k, v in d.items() if k in names}), d


@pytest.mark.parametrize("name", ["array7", "tiny_qc", "wifi"])
def test_ldpc_code_and_decoder_are_the_ports(name, tmp_path):
    cfg, d = ldpc_case(name, tmp_path)
    port = build_code(cfg)
    mine = ldpc.Code(d, "cpu")
    np.testing.assert_array_equal(mine.G.numpy().astype(np.uint8), port.G)
    np.testing.assert_array_equal(mine.msg.numpy(), port.message_positions)
    from sparc_ldpc_tpu_torch.models.ldpc import LdpcModel
    lm = LdpcModel.build(cfg, "cpu")
    g = torch.Generator().manual_seed(3)
    u = torch.randint(0, 2, (40, mine.k), generator=g)
    cw = mine.encode(u)
    assert torch.equal(cw, lm.encode(u.to(torch.int32)))
    llr = (1.0 - 2.0 * cw) * 2.0 + 1.7 * torch.randn(cw.shape, generator=g)
    a, b = lm.decode(llr.to(torch.float32)), mine.decode(llr.to(
        torch.float32))
    assert torch.equal(a.hard, b["hard"]) and torch.equal(a.ok, b["ok"])
    assert torch.equal(a.iters, b["iters"])
    # some codewords end unverified, so the comparison covers both ends
    assert 0 < int(b["ok"].sum()) < 40 or name == "array7"


def test_the_configs_base_matrix_is_the_ports_data_file():
    from sparc_ldpc_tpu_torch.design.ldpc_codes import load_qc_base

    d = config_file("concat_wifi")["ldpc"]
    shifts, Z = load_qc_base(d["path"])
    assert d["qc_base"]["Z"] == Z
    np.testing.assert_array_equal(d["qc_base"]["shifts"], shifts)


@pytest.mark.parametrize("L,logM,n,f", [(1024, 9, 744, 0.5), (64, 6, 56, 0.5),
                                        (1024, 9, 648, 0.28)])
def test_partition_is_the_ports(L, logM, n, f):
    assert codes.partition(L, logM, n, f) == _derive_partition(L, logM, n, f)


@pytest.mark.parametrize("preset,config,bits", [
    ("concat", None, 8490), ("concat_wifi", "concat_wifi", 8244)])
def test_concat_message_bits_are_the_ports(preset, config, bits):
    cfg = slt.PRESETS[preset]
    d = as_dict(cfg.ldpc) if config is None else config_file(config)["ldpc"]
    ref = ldpc.Code(d, "cpu")
    Lu, _, num_cw = codes.partition(1024, 9, ref.n, cfg.f_prot)
    assert Lu * 9 + num_cw * ref.k == bits
    if config is not None:
        from benchmark.systems.concat import System
        assert System.message_bits(config_file(config)) == bits


@pytest.mark.parametrize("kind", ["sparc", "concat"])
def test_a_block_decodes_alike(kind):
    """A whole block on the CPU: the port (bf16, its plain versions) and
    the reference (bf16) deliver nearly the same errors."""
    from sparc_ldpc_tpu_torch.utils.rng import block_generator
    if kind == "sparc":
        cfg = slt.SparcConfig(**SMALL)
        model = SparcModel.build(cfg, 3.0, "cpu")
        ref = codes.Sparc(as_dict(cfg), 3.0, "cpu")
    else:
        cfg = small_concat()
        model = ConcatModel.build(cfg, 3.0, "cpu")
        d = dict(sparc=as_dict(cfg.sparc), ldpc=as_dict(cfg.ldpc),
                 f_prot=cfg.f_prot, feedback_iters=cfg.feedback_iters)
        ref = codes.Concat(d, 3.0, "cpu")
    out = model.run_block(block_generator(7, 1, 2, "cpu"), 48)
    fr = ref.frames(7, 1, 2, 48, "cpu")
    be = int(out["bit_errors"])
    assert abs(be - int(fr["bit_errors"].sum())) <= 0.05 * be + 20
    # early stop on a 64-section tau2 is sensitive to rounding
    assert abs(int(out["iters_sum"]) - int(fr["iters"].sum())) <= (
        0.1 * int(out["iters_sum"]))
