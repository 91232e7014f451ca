"""The benchmark's `fast_l4096` cell: its files run the preset as shipped,
and the port decodes that configuration's shape as the benchmark's plain
reference does (benchmark/reference, PyTorch and NumPy, no JAX).

The shape is `fast_l4096`'s fields (R = 1.5, the iterative allocation,
per-codeword early stop at tol 1e-4 with a cap of 32, encode and noise
in the kernel, bf16 transforms) with L cut to 2048, so that K1's
L > 1024 form is the route taken, and M to 32, the narrowest tile the
split form's tables take (32-column strips).  The port runs its normal
path (`SparcModel.run_block`, the per-frame outputs of `frame_counts`,
`amp_fused`'s plain version on the CPU); the reference decodes the same
(base, point, block) draws (`codes.Sparc.frames`).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

import sparc_ldpc_tpu_torch.models.amp as model_amp
from benchmark.harness import spec
from benchmark.reference import codes
from benchmark.systems.sparc import program_config
from sparc_ldpc_tpu_torch.config import PRESETS
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
from sparc_ldpc_tpu_torch.utils.rng import block_generator

CELL = "fast_l4096.b512_6p5db"
SHAPE = PRESETS["fast_l4096"].replace(L=2048, M=32)
EBNO_DB, B, BASE, BLOCKS = 6.5, 8, 2 ** 31 + 23, 3
# sections whose top two posterior values lie closer than this share of
# the top one are near-ties, which rounding noise may flip: in float32
# models/amp.py decision_flips' margin (the reference's tests/
# test_precision.py rule); in bf16 the two decodes' rounding noise moves a
# section's posterior by a few hundredths of its top value (flips at
# margins up to 0.05 on both sides on these draws), so 0.1
TIE_MARGIN = {"float32": 2e-2, "bf16": 0.1}


def test_the_cell_runs_the_preset_as_shipped():
    bench = spec.benchmark()
    cell = spec.cell(CELL, bench)
    cfg = cell["config_file"]
    assert cfg["system"] == "sparc" and cfg["reduced"] == []
    preset = dataclasses.asdict(PRESETS["fast_l4096"])
    for k, v in preset.items():
        assert cfg[k] == v, k
    assert program_config(cfg) == PRESETS["fast_l4096"]
    entry, = [c for c in bench["configs"] if c["name"] == "fast_l4096"]
    assert entry["file"] == "benchmark/configs/fast_l4096.json"
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert cell["config"] == "fast_l4096" and cell["chips"] == 1
    traffic = cell["traffic_file"]
    assert traffic == dict(batch=512, ebno_db=6.5, blocks_per_call=8)
    # every size that no source fixes is one the cell runs
    for k in cfg["assumed"]:
        assert k in cfg or k in traffic, k
    checks = cell["check_file"]
    assert checks["check_blocks"] in (1, 2) and checks["limits"]


@pytest.fixture(scope="module")
def models():
    return {p: SparcModel.build(SHAPE, EBNO_DB, "cpu")
            for p in ("bf16", "float32")}


def decode_both(model, precision, monkeypatch, block):
    """One block of B codewords decoded by the port (its run_block, the
    transforms at `precision`) and the reference: (the port's per-frame
    outputs, its amp_fused result, the reference's frames and beta)."""
    seen = {}
    kernel_precision = "bf16" if precision == "bf16" else "highest"

    def fused(*a, **kw):
        seen["amp"] = amp_fused(*a, precision=kernel_precision, **kw)
        return seen["amp"]

    frame_counts = model.frame_counts

    def frames(*a, **kw):
        seen["frames"] = frame_counts(*a, **kw)
        return seen["frames"]

    monkeypatch.setattr(model_amp, "amp_fused", fused)
    object.__setattr__(model, "frame_counts", frames)
    try:
        out = model.run_block(block_generator(BASE, 0, block, "cpu"), B)
    finally:
        object.__delattr__(model, "frame_counts")
    ref = codes.Sparc(dataclasses.asdict(SHAPE), EBNO_DB, "cpu", precision)
    amp = ref.amp

    def ref_amp(*a, **kw):
        out = amp(*a, **kw)
        seen["ref"] = dict(out)         # frames takes beta out of its dict
        return out

    ref.amp = ref_amp
    fr = ref.frames(BASE, 0, block, B, "cpu")
    mine = {k: v.numpy() for k, v in seen["frames"].items()}
    assert int(out["iters_sum"]) == mine["iters"].sum()
    return mine, seen["amp"], fr, seen["ref"]["beta"]


def near_ties(beta_a, beta_b, margin):
    """(B, L) bool: sections where either side's top two are near-ties."""
    def tie(x):
        top2 = x.to(torch.float64).topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]) <= margin * top2[..., 0]
    return tie(beta_a) | tie(beta_b)


def stop_near_ties(trace, iters, tol):
    """(B,) bool: frames whose plateau test |dtau2| < tol tau2 read, at
    some iteration they ran, within a factor 1.5 of its threshold (the
    port's trace): summation order alone may move such a stop."""
    t = trace.to(torch.float64)
    ratio = (t[1:] - t[:-1]).abs() / (tol * t[1:])
    ran = torch.arange(1, t.shape[0])[:, None] < iters[None, :]
    close = (ratio > 1 / 1.5) & (ratio < 1.5) & ran
    return close.any(0)


def test_port_holds_to_the_reference_float32(models, monkeypatch):
    """Transforms in float32 on both sides: one function, the summation
    order apart.  Every frame stops at the same iteration (unless its
    plateau test sat within 1.5x of tol), every decisive section decides
    alike, and the last tau2 agrees to 2e-5: the two orders of float32
    sums (butterflies against dense products) differ by a few 1e-7 an
    iteration, which 32 iterations grow to a few 1e-6 (5e-6 at most on
    these draws)."""
    model = models["float32"]
    compared = 0
    for block in range(BLOCKS):
        mine, (beta, trace, iters), fr, rbeta = decode_both(
            model, "float32", monkeypatch, block)
        keep = ~stop_near_ties(trace, iters, SHAPE.amp_tol).numpy()
        compared += int(keep.sum())
        np.testing.assert_array_equal(mine["iters"][keep], fr["iters"][keep])
        np.testing.assert_array_equal(mine["iters"], iters.numpy())
        ties = near_ties(beta, rbeta, TIE_MARGIN["float32"])
        flips = (beta.argmax(-1) != rbeta.argmax(-1)) & ~ties
        assert int(flips[torch.as_tensor(keep)].sum()) == 0
        np.testing.assert_allclose(mine["tau2_final"][keep],
                                   fr["tau2"][keep], rtol=2e-5)
        np.testing.assert_array_equal(mine["section_errors"][keep],
                                      fr["section_errors"][keep])
        np.testing.assert_array_equal(mine["bit_errors"][keep],
                                      fr["bit_errors"][keep])
    # the exemption is rare: it may not empty the comparison
    assert compared >= 0.75 * BLOCKS * B


def test_port_holds_to_the_reference_bf16(models, monkeypatch):
    """The configuration's bf16 transforms on both sides, rounded at the
    same places (before H_M and before H_L) with float32 sums in another
    order.  Two sums that differ in their last float32 bit may round to
    neighbouring bf16 values, so the two decodes draw different rounding
    noise, about 1e-2 of tau2 while a frame decodes.  After a frame
    converges its tau2 moves by about tol = 1e-4 of itself an iteration,
    the size of that noise, so its stop is the noise's: the plateau test
    moves a frame's stop by up to 4 of its 20-32 iterations on these
    draws, and the float32 test pins the stop exactly.
    Held here: every decisive section decides alike, a frame's
    iterations within 6 of the reference's and the block's within 10 %
    (up to 5.4 % on these draws),
    the section and bit errors of each frame within one section, and the
    last tau2 within 2e-3, ten times the largest gap of frames that
    converge (1.5e-4 to 4.7e-4 on these draws)."""
    model = models["bf16"]
    logM = SHAPE.M.bit_length() - 1
    for block in range(BLOCKS):
        mine, (beta, trace, iters), fr, rbeta = decode_both(
            model, "bf16", monkeypatch, block)
        ties = near_ties(beta, rbeta, TIE_MARGIN["bf16"])
        assert int(((beta.argmax(-1) != rbeta.argmax(-1)) & ~ties).sum()) == 0
        gap = np.abs(mine["iters"].astype(int) - fr["iters"])
        assert gap.max() <= 6
        assert abs(int(mine["iters"].sum()) - int(fr["iters"].sum())) <= (
            0.1 * fr["iters"].sum())
        assert np.all(np.abs(mine["section_errors"] - fr["section_errors"])
                      <= 1)
        assert np.all(np.abs(mine["bit_errors"] - fr["bit_errors"]) <= logM)
        np.testing.assert_allclose(mine["tau2_final"], fr["tau2"],
                                   rtol=2e-3)
