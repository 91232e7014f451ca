"""The layered kernel's compression of the check messages is lossless.

csrc/bp_qc_layered.cu keeps, for each (layer, check), min1, min2, the signs
of the layer's blocks' extrinsic messages as bits and the bits of the
blocks whose magnitude equalled min1, and rebuilds the previous
iteration's message of each block from them; after iteration 0 it runs
the zero-block clip only at the reduced list of `layer_table`.  This file
holds a plain PyTorch model of that recurrence (the kernel's order of
float operations, vectorised over codewords) to the plain layered engine
`ops.bp_qc.bp_decode_qc(schedule="layered")`, bit for bit: hard
decisions, ok flags, iteration counts and float32 posteriors compared on
their int32 view, so signed zeros count.  The LLRs are quantised to a few
levels, so that magnitudes tie at min1 and min2 == min1, and hold -0.0,
+-clip and values beyond the clip.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu_torch.config import LdpcConfig
from sparc_ldpc_tpu_torch.design.ldpc_codes import build_code, qc_structure
from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import layer_table

# every QC code the port ships: the concat array code and the six tables
CODES = {
    "array31": LdpcConfig(kind="array", z=31, rows_b=4, cols_b=24),
    **{p: LdpcConfig(kind="qc", path=p) for p in (
        "wifi_n648_r12", "wifi_n1296_r12", "wifi_n1944_r12",
        "qc_n648_r23", "qc_n648_r34", "qc_n648_r56")},
}
CLIP = 20.0
BATCH = 6


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def check_state_decode(llr, shifts, Z, iters, method, alpha=0.8125,
                       beta=0.15, clip=CLIP):
    """The kernel's recurrence: check state (min1, min2, sign bits, min1
    bits) per (layer, check), messages rebuilt from it, the zero-block
    clip at every zero block in iteration 0 and at the reduced list after.
    Returns (hard, ok, iters, posterior) and the number of checks at which
    min2 == min1 occurred (ties)."""
    lt = layer_table(shifts)
    s = np.asarray(shifts)
    J, K = s.shape
    B = llr.shape[0]
    c = _f32(clip)
    zc = torch.arange(Z)

    def magnitude(x):
        w = (torch.maximum(x - _f32(beta), _f32(0.0)) if method == "oms"
             else _f32(alpha) * x)
        return torch.clamp(w, -c, c)

    def messages(m1, m2, sign_bits, eq_bits):
        """(B, deg, Z) messages from a layer's check state: the magnitude
        of min2 where the block held min1, else min1's, negated where the
        block's sign differs from the product of the others'."""
        neg = sign_bits ^ (sign_bits.sum(1, keepdim=True) & 1)
        w = torch.where(eq_bits.bool(), magnitude(m2)[:, None],
                        magnitude(m1)[:, None])
        return torch.where(neg.bool(), -w, w)

    tot = torch.clamp(llr, -c, c).reshape(B, K, Z).clone()
    state = None                      # per layer: (m1, m2, signs, eqs)
    done = torch.zeros(B, dtype=torch.bool)
    it = torch.zeros(B, dtype=torch.int32)
    ties = 0
    zero_lists = [[k for k in range(K) if s[j, k] < 0] for j in range(J)]
    reduced = [[k for jj, k in lt.reduced if jj == j] for j in range(J)]
    for i in range(iters):
        new_tot, new_state = tot.clone(), []
        for j in range(J):
            ks = [k for k in range(K) if s[j, k] >= 0]
            pos = [(zc + int(s[j, k])) % Z for k in ks]
            at = torch.stack([new_tot[:, k, p] for k, p in zip(ks, pos)], 1)
            old = (torch.zeros_like(at) if state is None
                   else messages(*state[j]))
            mv = torch.clamp(at - old, -c, c)           # (B, deg, Z)
            mag = mv.abs()
            m1 = torch.full((B, Z), float("inf"))
            m2 = torch.full((B, Z), float("inf"))
            for a in range(len(ks)):                    # the two-min rule
                m2 = torch.minimum(m2, torch.maximum(m1, mag[:, a]))
                m1 = torch.minimum(m1, mag[:, a])
            signs = (mv < 0).to(torch.int64)
            eqs = (mag == m1[:, None]).to(torch.int64)
            ties += int(((m1 == m2) & ~done[:, None]).sum())
            new = messages(m1, m2, signs, eqs)
            for a, (k, p) in enumerate(zip(ks, pos)):
                new_tot[:, k, p] = mv[:, a] + new[:, a]
            new_state.append((m1, m2, signs, eqs))
            for k in (zero_lists[j] if i == 0 else reduced[j]):
                new_tot[:, k] = torch.clamp(new_tot[:, k], -c, c) + _f32(0.0)
        hard = (new_tot < 0).to(torch.int64)
        syn = torch.zeros((B,), dtype=torch.bool)
        for j in range(J):
            par = sum(hard[:, k, (zc + int(s[j, k])) % Z]
                      for k in range(K) if s[j, k] >= 0)
            syn |= (par & 1).bool().any(-1)
        # a codeword that passed keeps its totals (its state is its own and
        # is read by nothing else)
        tot = torch.where(done[:, None, None], tot, new_tot)
        state = new_state
        it = it + (~done).to(torch.int32)
        done = done | ~syn
    post = tot.reshape(B, K * Z)
    return ((post < 0).to(torch.uint8), done, it, post), ties


def _llrs(cfg, seed):
    """Noisy BPSK LLRs quantised to steps of 1.0 (ties), with -0.0 and,
    of the sent symbol's sign, +-clip and +-25 planted."""
    code = build_code(cfg)
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (BATCH, code.k)))
    sigma = 0.7 if code.k * 2 <= code.n else 0.45
    x = 1.0 - 2.0 * cw
    # the last two codewords at twice the noise: they run every iteration
    noise = sigma * rng.standard_normal(cw.shape)
    noise[-2:] *= 2.0
    llr = np.round(2.0 * (x + noise) / sigma ** 2).astype(np.float32)
    planted = rng.random(llr.shape)
    llr[planted < 0.03] = -0.0
    big = (planted >= 0.03) & (planted < 0.06)
    llr[big] = (x * np.where(planted < 0.045, CLIP, 25.0))[big]
    return torch.tensor(llr)


def _shifts(cfg):
    shifts, Z = qc_structure(cfg)
    return tuple(tuple(int(v) for v in row) for row in shifts), Z


@pytest.mark.parametrize("iters", [0, 1, 20])
@pytest.mark.parametrize("method", ["minsum", "oms"])
@pytest.mark.parametrize("name", list(CODES))
def test_check_state_model_bitwise_equals_plain_layered(name, method, iters):
    cfg = CODES[name]
    shifts, Z = _shifts(cfg)
    llr = _llrs(cfg, seed=len(name))
    assert (llr == 0).any() and (torch.signbit(llr) & (llr == 0)).any()
    (hard, ok, it, post), ties = check_state_decode(llr, shifts, Z, iters,
                                                    method)
    rp = bp_decode_qc(llr, QcBpTables.build(np.asarray(shifts), Z),
                      iters=iters, method=method, clip=CLIP,
                      schedule="layered")
    assert torch.equal(post.view(torch.int32), rp.posterior.view(torch.int32))
    assert torch.equal(hard, rp.hard)
    assert torch.equal(ok, rp.ok)
    assert torch.equal(it, rp.iters)
    if iters:
        assert ties > 0, "no check saw min2 == min1"
    if iters == 20:
        assert 0 < int(ok.sum()) < BATCH, "want decoded and failed codewords"
        assert int(it.max()) == iters



@pytest.mark.parametrize("method", ["minsum", "oms"])
def test_iteration_zero_clips_every_zero_block(method):
    """Iteration 0 runs the zero-block clip at every zero block: there a
    -0.0 that no layer has written turns into +0.0.  Column 0 of this base
    matrix is in no layer, so the reduced list never reaches it and only
    iteration 0's full pass makes its -0.0 LLR the plain engine's +0.0."""
    shifts = ((-1, 0, 0), (-1, 0, 1))
    Z = 2
    assert all(k != 0 for _, k in layer_table(shifts).reduced)
    llr = torch.tensor([[-0.0, -0.0, 1.0, -2.0, 3.0, 1.0]])
    for iters in (1, 3):
        (_, _, _, post), _ = check_state_decode(llr, shifts, Z, iters, method)
        rp = bp_decode_qc(llr, QcBpTables.build(np.asarray(shifts), Z),
                          iters=iters, method=method, clip=CLIP,
                          schedule="layered")
        assert torch.equal(post.view(torch.int32),
                           rp.posterior.view(torch.int32))
        assert not torch.signbit(post[0, :Z]).any()
