"""Same received words, both packages, at ROADMAP Queue C's C3 point.

`plain_small` (L=256, M=512, flat power, R=1) at 3.0 dB sits on its
waterfall: the port's float32 BER legs there lie above the float64
oracle's.  This is check 1 of the North star ("same inputs, same
outputs") at that exact point, on the CPU:

  float32  256 trials' received words, made once with numpy from a fixed
           seed, go through the JAX package's float32 XLA route
           (amp_kernel="xla", transform_precision="highest", amp_tol=0:
           the reference's `control_f32xla` overrides) and through the
           port's `torch_control_f32` route (the same config, the port's
           scan route).  Decisions are held by the margin-aware rule of
           tests/test_precision.py (no decisive flip, at most 1 % of
           sections flipped); a trial's section errors may differ only
           where a flipped section is a near-tie; tau^2 traces agree
           within 1e-4 relative.
  float64  32 of those words go through the reference's float64 oracle
           (`sparc_ldpc_tpu.oracle.sparc.amp_decode`) and through the
           port's scan route in float64: decisions equal.

If the float32 check failed, the port's float32 route would decide
otherwise than the reference's float32 route on the same words, and C3
would be a fault of the port.  About 60 s on one CPU (the two float32
decodes of (256, 2^17) tiles over 32 iterations take most of it; the
oracle decodes run four at a time).
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import PRESETS as JPRESETS
from sparc_ldpc_tpu.models.sparc import SparcModel as JModel
from sparc_ldpc_tpu.oracle import sparc as osparc
from sparc_ldpc_tpu.utils.bits import np_bits_to_indices
from test_precision import assert_decisions_match

from sparc_ldpc_tpu_torch.models.amp import amp_decode
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.tools import ber_legs as bl

EBNO = 3.0
TRIALS = 256
F64_TRIALS = 32
REL_MARGIN = 2e-2          # assert_decisions_match's default
# the reference's control_f32xla overrides (scripts/concat_f32_control.py)
F32 = dict(amp_kernel="xla", amp_tol=0.0, transform_precision="highest")


def _words():
    """The JAX config, the port's model, the true indices (TRIALS, L) and
    the received words y (TRIALS, n) float32: the float64 oracle encode
    plus float64 noise from a fixed seed, rounded once to float32."""
    jcfg = replace(JPRESETS["plain_small"], **F32)
    model = SparcModel.build(bl.leg_config("plain_small",
                                           "torch_control_f32"), EBNO, "cpu")
    assert model.cfg.L == 256 and model.cfg.M == 512
    assert model.cfg.power_alloc == "flat"
    rng = np.random.default_rng(20261017)
    bits = rng.integers(0, 2, (TRIALS, jcfg.k_bits))
    op = osparc.make_operator(jcfg)
    x = np.stack([osparc.encode(b, jcfg, model.p_alloc, op) for b in bits])
    y = x + rng.standard_normal(x.shape) * np.sqrt(model.sigma2)
    idx = np_bits_to_indices(bits, jcfg.logM)
    return jcfg, op, model, idx, y.astype(np.float32)


def _near_tie(beta):
    """(B, L) bool: the section's top-2 relative margin is at most
    REL_MARGIN (the rule's flagged near-ties)."""
    s = np.sort(beta, -1)
    gap = (s[..., -1] - s[..., -2]) / np.maximum(s[..., -1], 1e-30)
    return gap <= REL_MARGIN


def test_float32_routes_decide_alike_and_float64_matches_the_oracle():
    jcfg, op, model, idx, y = _words()
    assert repr(model.cfg) == repr(jcfg)

    # float32: the JAX package's XLA route against the port's control route
    jm = JModel.build(jcfg, ebno_db=EBNO)
    np.testing.assert_allclose(np.asarray(jm.sq_npl),
                               model.sq_npl.numpy(), rtol=1e-7)
    rj = jm.decode(jnp.asarray(y))
    bj, tj = np.asarray(rj.beta), np.asarray(rj.tau2_trace)
    del rj
    rt = model.decode(torch.from_numpy(y))
    bt, tt = rt.beta.numpy(), rt.tau2_trace.numpy()
    del rt
    assert bj.shape == bt.shape == (TRIALS, 256, 512)
    assert_decisions_match(bj, bt)
    hj, ht = bj.argmax(-1), bt.argmax(-1)
    ej, et = (hj != idx).sum(-1), (ht != idx).sum(-1)
    flagged = ((hj != ht) & (_near_tie(bj) | _near_tie(bt))).any(-1)
    assert not ((ej != et) & ~flagged).any(), np.flatnonzero(ej != et)
    # the point is a waterfall: a share of the words fail, others decode
    assert 0 < (ej > 0).sum() < TRIALS
    np.testing.assert_allclose(tt, tj, rtol=1e-4)

    # float64: the reference's oracle against the port's scan route
    y64 = y[:F64_TRIALS].astype(np.float64)
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda w: osparc.amp_decode(
            w, jcfg, model.p_alloc, op), y64))
    ho = np.stack([o.beta.reshape(jcfg.L, jcfg.M).argmax(-1) for o in outs])
    sq64 = torch.from_numpy(np.sqrt(jcfg.n * model.p_alloc))
    r64 = amp_decode(torch.from_numpy(y64), model.op, sq64, jcfg.P, jcfg.n,
                     T=jcfg.amp_iters, tol=0.0)
    assert r64.beta.dtype == torch.float64
    np.testing.assert_array_equal(r64.beta.numpy().argmax(-1), ho)
    assert np.all([o.iters == jcfg.amp_iters for o in outs])
