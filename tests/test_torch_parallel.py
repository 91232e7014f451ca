"""The port's multi-device path (sparc_ldpc_tpu_torch.parallel: mesh.py,
amp_sharded.py, dist_fwht.py, and the models, campaign and CLI under a
ShardingPolicy) against the JAX reference on its 8 fake CPU devices
(tests/conftest.py), the port on virtual meshes of the CPU.

Both packages get the same NumPy inputs.  Contracts, each with its
tolerance:
  - K3 (`fwht_tile`, bf16 operands, scale) against the reference's tile
    kernel in interpret mode: bit for bit on integer inputs (every sum is
    exact, so only the rounding points matter, and they are the same);
    on normal inputs to 2e-3 of the output scale (the two sum in other
    orders, so a bf16 rounding of the intermediate can fall the other
    way, which moves the outputs by up to 2^-8 of that value);
  - section-sharded AMP against the reference's `amp_fused_sharded`:
    margin-aware decisions (`assert_decisions_match`), tau2 traces to
    rtol 2e-2 (bf16 transforms), equal iteration counts with tol at a
    decisive point;
  - `dist_fwht` against the reference's and against the local transform
    in float32: rtol 1e-5, atol 1e-3 (the reference's own rule);
  - models under a policy against the single device on the same draws:
    integer counters equal.  tau2_final to rtol 1e-5: on the CPU the plain
    routes go through BLAS (`fwht_kron`), whose summation order may
    change with the batch size, so floats are not compared with ==.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.ops.amp_kernel import fwht_tile_pallas
from sparc_ldpc_tpu.parallel import mesh as jmesh
from sparc_ldpc_tpu.parallel.amp_sharded import (
    amp_fused_sharded as j_amp_fused_sharded)
from sparc_ldpc_tpu.parallel.dist_fwht import dist_fwht as j_dist_fwht
from test_precision import assert_decisions_match

from sparc_ldpc_tpu_torch import cli as tcli
from sparc_ldpc_tpu_torch.config import (
    CampaignConfig, ConcatConfig, LdpcConfig, SparcConfig)
from sparc_ldpc_tpu_torch.design.se import se_trajectory
from sparc_ldpc_tpu_torch.models import amp as amp_mod
from sparc_ldpc_tpu_torch.models import sparc as sparc_mod
from sparc_ldpc_tpu_torch.models.amp import hard_indices
from sparc_ldpc_tpu_torch.models.concat import ConcatModel
from sparc_ldpc_tpu_torch.models.sparc import SparcModel, SparcSweep
from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused, fwht_tile
from sparc_ldpc_tpu_torch.ops.fwht import fwht_kron, hadamard_factor
from sparc_ldpc_tpu_torch.parallel import amp_sharded
from sparc_ldpc_tpu_torch.parallel import mesh as mesh_mod
from sparc_ldpc_tpu_torch.parallel.amp_sharded import amp_fused_sharded
from sparc_ldpc_tpu_torch.parallel.campaign import run_campaign, run_point
from sparc_ldpc_tpu_torch.parallel.dist_fwht import dist_fwht, hypercube
from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh
from sparc_ldpc_tpu_torch.utils import profiling as prof
from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
from sparc_ldpc_tpu_torch.utils.rng import block_generator

INTS = ("bit_errors", "frame_errors", "section_errors", "trials",
        "iters_sum", "bp_ok", "bit_errors_sq")
# the fused route at a decisive point (test_parallel.py's configuration)
FUSED = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12,
                    amp_tol=0.0, amp_kernel="fused",
                    transform_precision="bf16")
XLA = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12)


def cpu_policy(D, S):
    """A (D, S) virtual mesh of the CPU."""
    return ShardingPolicy(make_mesh(S, ["cpu"] * (D * S)))


def gathered(policy, parts):
    """amp_fused_sharded's (beta, trace, iterations) of each data shard,
    each field gathered onto the home device in shard order."""
    beta, trace, iters = zip(*parts)
    return (policy.gather(beta, 0), policy.gather(trace, 1),
            policy.gather(iters, 0))


def block(model, batch=16, seed=3):
    out = model.run_block(block_generator(seed, 0, 0, model.device), batch)
    return {k: v.item() for k, v in out.items()}


def assert_same_block(got, want):
    assert {k: got[k] for k in INTS if k in want} == \
        {k: want[k] for k in INTS if k in want}
    if "tau2_final" in want:
        np.testing.assert_allclose(got["tau2_final"], want["tau2_final"],
                                   rtol=1e-5)


# ------------------------------------------------------------- the mesh

def test_make_mesh_shapes():
    assert make_mesh(2, ["cpu"] * 8).shape == (4, 2)
    assert make_mesh(1, ["cpu"] * 8).shape == (8, 1)
    with pytest.raises(ValueError):
        make_mesh(3, ["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)


def test_policy_splits_rows_and_sections_and_gathers():
    pol = ShardingPolicy(make_mesh(2, ["cpu"] * 4), rank=1, world=2)
    assert (pol.data_shards, pol.section_shards) == (2, 2)
    assert pol.process_rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        pol.check_batch(6)
    x = torch.arange(4 * 8 * 2.0).reshape(4, 8, 2)
    rows = pol.split_data(x)
    assert [tuple(r.shape) for r in rows] == [(2, 8, 2)] * 2
    slabs = pol.split_sections(rows[1], 1, 1)
    assert [tuple(s.shape) for s in slabs] == [(2, 4, 2)] * 2
    assert all(s.is_contiguous() for s in slabs)
    assert torch.equal(pol.gather([pol.gather(slabs, 1), rows[0]], 0),
                       torch.cat([x[2:], x[:2]]))
    assert pol.split_data(None) == [None, None]
    one = ShardingPolicy(pol.mesh)
    vals = torch.ones(3, dtype=torch.float64)
    assert one.broadcast("x") == "x"
    assert torch.equal(one.all_reduce(vals), vals)


def test_hypercube_on_one_device_computes_h_s():
    """On a virtual mesh the S blocks share a device: every new block must
    come from the old ones (H_S (x) I against the explicit product)."""
    S, n = 8, 5
    parts = [torch.randn(2, n, dtype=torch.float64) for _ in range(S)]
    got = torch.stack(hypercube(parts))                    # (S, 2, n)
    want = torch.einsum("st,tbn->sbn", hadamard_factor(S).double(),
                        torch.stack(parts))
    torch.testing.assert_close(got, want)


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("l,M", [(64, 64), (64, 256), (256, 64),
                                 (256, 256)])
def test_fwht_tile_matches_jax_tile_kernel(l, M):
    """l = 64 is one f_b = l slab and l = 256 two (f_a = 2); M = 64 one
    column block and M = 256 two (m_a = 2)."""
    scale = 1.0 / np.sqrt(l * M / 2)
    rng = np.random.default_rng(l + M)
    ints = rng.integers(-8, 9, (2, l, M)).astype(np.float32)
    normal = rng.standard_normal((2, l, M)).astype(np.float32)
    for x, tol in ((ints, 0.0), (normal, 2e-3)):
        want = np.asarray(fwht_tile_pallas(jnp.asarray(x), scale=scale,
                                           interpret=True))
        launches = fwht_tile.launches
        got = fwht_tile(torch.tensor(x), "bf16", scale).numpy()
        assert fwht_tile.launches == launches      # CPU: the plain version
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, (l, M, err)


# ----------------------------------------------- section-sharded AMP

SHARD_CFG = SparcConfig(L=128, M=64, R=1.0, op_kind="hadamard", amp_iters=8,
                        amp_tol=0.0, amp_kernel="fused",
                        transform_precision="bf16")


def _sharded_inputs(B=4, ebno=6.0, seed=0):
    """A decisive point's y_n, constants, true indices and 40 % pins."""
    m = SparcModel.build(SHARD_CFG, ebno, "cpu")
    c = m.cfg
    rng = np.random.default_rng(seed)
    bits = torch.tensor(rng.integers(0, 2, (B, c.k_bits)), dtype=torch.int32)
    noise = torch.tensor(rng.standard_normal((B, c.n)), dtype=torch.float32)
    y = m.encode(bits) + noise * float(np.sqrt(m.sigma2))
    idx = bits_to_indices(bits, c.logM)
    rows = torch.tensor(rng.random((B, c.L)) < 0.4)
    pin = torch.where(rows, idx, -1).to(torch.int32)
    tr = se_trajectory(m.p_alloc, c.n, c.M, m.sigma2, T=c.amp_iters)
    sched = np.pad(tr[1:], (0, max(0, c.amp_iters - len(tr) + 1)),
                   mode="edge")[:c.amp_iters].astype(np.float32)
    return (m, m.op.embed_y(y).reshape(B, c.L, c.M),
            m.op.mask.reshape(c.L, c.M), idx, pin, torch.tensor(sched))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("option", ["fixed T", "tol", "pins", "schedule"])
def test_section_sharded_amp_matches_jax(S, option):
    m, y_n, mask, idx, pin, sched = _sharded_inputs()
    c = m.cfg
    kw = {"fixed T": {}, "tol": dict(tol=1e-4), "pins": dict(pin_idx=pin),
          "schedule": dict(tau2_schedule=sched)}[option]
    T = 16 if option == "tol" else c.amp_iters     # room for the stop
    jkw = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
           for k, v in kw.items()}
    mesh = jmesh.make_mesh(section_shards=S)
    with jax.sharding.set_mesh(mesh):
        bj, tj, ij = j_amp_fused_sharded(
            jnp.asarray(y_n.numpy()), jnp.asarray(mask.numpy()),
            jnp.asarray(m.sq_npl.numpy()), c.P, c.n, T,
            jmesh.ShardingPolicy(mesh), interpret=True, **jkw)
    pol = cpu_policy(2, S)
    bt, tt, it = gathered(pol, amp_fused_sharded(y_n, mask, m.sq_npl, c.P,
                                                 c.n, T, pol, **kw))
    assert_decisions_match(np.asarray(bj), bt.numpy())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if option == "tol":
        assert int(it.sum()) < idx.shape[0] * T, "no early stop"
    if option == "pins":
        # pinned rows hold exactly sq * one_hot
        rows = pin >= 0
        want = torch.where(torch.arange(c.M) == pin[..., None].long(),
                           m.sq_npl[None, :, None], 0.0)
        assert torch.equal(bt[rows], want[rows])
    if option == "schedule":
        assert torch.equal(tt, sched[:, None].expand_as(tt))


def test_section_sharded_amp_refuses_in_kernel_encode():
    m, y_n, mask, idx, _, _ = _sharded_inputs()
    with pytest.raises(ValueError, match="whole"):
        amp_fused_sharded(y_n, mask, m.sq_npl, 1.0, m.cfg.n, 2,
                          cpu_policy(1, 2), encode_idx=idx)
    with pytest.raises(ValueError, match="divisible"):
        amp_fused_sharded(y_n, mask, m.sq_npl, 1.0, m.cfg.n, 2,
                          cpu_policy(1, 256))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("option", ["noise", "schedule", "scan"])
def test_data_parallel_stages_every_shards_tables_before_the_first_launch(
        D, option, monkeypatch):
    """The data-parallel loops copy every shard's tables onto its device
    (`ShardingPolicy.stage`: the `mesh.shard_inputs` interval of each
    shard but the home one) before they queue the first shard's launch:
    a copy between two cards runs behind the work queued on both, so a
    copy queued after the home card's launch would hold its card until
    that launch ends.  The fused route stages mask, sq_npl, the schedule
    and the split tables before its first amp_fused; the scan route
    (amp_decode without fused) sq_npl and the schedule before its first
    shard's decode.  The order moves no result: beta, trace and
    iterations are the single-device calls', bit for bit."""
    m, y_n, mask, idx, pin, sched = _sharded_inputs(B=8)
    c = m.cfg
    order = []
    opened = mesh_mod.interval

    @contextlib.contextmanager
    def interval(name, dev):
        order.append(name)
        with opened(name, dev):
            yield

    monkeypatch.setattr(mesh_mod, "interval", interval)
    if option == "scan":        # y given, pins and the SE schedule
        gen = torch.Generator().manual_seed(5)
        y = m.op.Ax(m.build_beta(idx)) + torch.randn(
            (8, c.n), generator=gen) * float(np.sqrt(m.sigma2))
        kw = dict(tau2_schedule=sched, pinned_mask=pin >= 0,
                  pinned_idx=pin.clamp_min(0))
        decode = amp_mod.amp_decode
        parts = [decode(y_d, m.op, m.sq_npl, c.P, c.n, c.amp_iters,
                        tau2_schedule=sched, pinned_mask=pin_d >= 0,
                        pinned_idx=pin_d.clamp_min(0)).parts[0]
                 for y_d, pin_d in zip(y.chunk(D), pin.chunk(D))]
        want = [torch.cat(f, dim) for f, dim in zip(zip(*parts), (0, 1, 0))]

        def launch(*a, **k):
            order.append("launch")
            return decode(*a, **k)

        monkeypatch.setattr(amp_mod, "amp_decode", launch)
        res = decode(y, m.op, m.sq_npl, c.P, c.n, c.amp_iters,
                     policy=cpu_policy(D, 1), **kw)
        got = (res.beta, res.tau2_trace, res.iters)
    else:
        if option == "noise":   # the in-kernel encode and noise, fixed T
            seeds = torch.arange(16, dtype=torch.int32).reshape(8, 2) * 7919
            kw = dict(encode_idx=idx, noise_seed=seeds,
                      noise_sigma=float(np.sqrt(m.sigma2)))
            y = None
        else:                   # y given, pins and the SE schedule
            kw = dict(pin_idx=pin, tau2_schedule=sched)
            y = y_n
        want = amp_fused(y, mask, m.sq_npl, c.P, c.n, c.amp_iters,
                         split=True, **kw)
        fused = amp_sharded.amp_fused

        def launch(*a, **k):
            order.append("launch")
            return fused(*a, **k)

        monkeypatch.setattr(amp_sharded, "amp_fused", launch)
        pol = cpu_policy(D, 1)
        got = gathered(pol, amp_fused_sharded(
            y, mask, m.sq_npl, c.P, c.n, c.amp_iters, pol, split=True,
            split_support=m.op.split_support, **kw))
    assert order == ["mesh.shard_inputs"] * (D - 1) + ["launch"] * D
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ----------------------------------------------------------- models

@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("cfg", [
    FUSED.replace(amp_kernel="fused_split", amp_noise_in_kernel=True),
    FUSED, XLA], ids=["split+noise", "mono", "scan"])
def test_data_parallel_block_matches_single_device(D, cfg):
    want = block(SparcModel.build(cfg, 5.0, "cpu"))
    model = SparcModel.build(cfg, 5.0, None, policy=cpu_policy(D, 1))
    assert model.device == torch.device("cpu")
    assert model.noise_in_kernel == cfg.amp_noise_in_kernel
    assert_same_block(block(model), want)


DP_CFGS = [FUSED.replace(amp_kernel="fused_split", amp_noise_in_kernel=True),
           FUSED, XLA]
DP_IDS = ["split+noise", "mono", "scan"]


def _draws(model, batch=16, seed=3):
    """A block's draws: bits and either the noise or, with the in-kernel
    noise, its per-codeword keys."""
    gen = block_generator(seed, 0, 0, model.device)
    bits = torch.randint(0, 2, (batch, model.cfg.k_bits), generator=gen,
                         dtype=torch.int32, device=model.device)
    if model.noise_in_kernel:
        return bits, None, model.draw_seeds(gen, batch)
    return bits, torch.randn((batch, model.cfg.n), generator=gen), None


def _frames_and_results(model, draws, monkeypatch):
    """model.frame_counts on the draws, and the AmpResult it decided."""
    log, decode = [], sparc_mod.amp_decode

    def logged(*a, **kw):
        log.append(decode(*a, **kw))
        return log[-1]

    monkeypatch.setattr(sparc_mod, "amp_decode", logged)
    bits, noise, seeds = draws
    frames = model.frame_counts(bits, noise, noise_seed=seeds)
    monkeypatch.setattr(sparc_mod, "amp_decode", decode)
    (res,) = log
    return frames, res


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("cfg", DP_CFGS, ids=DP_IDS)
def test_data_mesh_decisions_are_the_single_devices(D, cfg, monkeypatch):
    """Under a data mesh frame_counts takes each shard's decisions on its
    device and gathers them: the per-frame bit and section errors,
    iterations and last tau2 of the single device, and beta, gathered
    when read afterwards, the single device's.  The fused routes' plain
    versions compute each codeword alone, so their floats are equal bit
    for bit; the scan route's transforms go through BLAS, whose summation
    order may follow the batch size, so its floats are held to rtol 1e-5
    (the module's rule) and its decisions to the argmax of its own beta."""
    one = SparcModel.build(cfg, 5.0, "cpu")
    draws = _draws(one)
    want, ref = _frames_and_results(one, draws, monkeypatch)
    model = SparcModel.build(cfg, 5.0, None, policy=cpu_policy(D, 1))
    got, res = _frames_and_results(model, draws, monkeypatch)
    assert len(res.parts) == D and len(ref.parts) == 1
    assert ref.beta is ref.parts[0][0]          # one part: no copy
    for k in ("bit_errors", "section_errors", "iters"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(res.decide(hard_indices), hard_indices(res.beta))
    if cfg is XLA:
        np.testing.assert_allclose(got["tau2_final"], want["tau2_final"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res.beta, ref.beta, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(got["tau2_final"], want["tau2_final"])
        assert torch.equal(res.beta, ref.beta)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("cfg", DP_CFGS, ids=DP_IDS)
def test_data_mesh_takes_every_decision_before_a_copy_home(D, cfg,
                                                         monkeypatch):
    """frame_counts queues every shard's argmax, each on its shard's
    device, before the first gather onto the home device (a copy between
    two cards waits for the work queued on both, so an argmax queued
    behind one would wait for the home card); then it gathers the
    indices, the iterations and the trace, and never beta."""
    order = []
    argmax, gather = sparc_mod.hard_indices, ShardingPolicy.gather

    def decide(beta):
        order.append(("argmax", beta.shape[0]))
        return argmax(beta)

    def gathered(self, parts, dim):
        order.append(("gather", parts[0].dtype))
        return gather(self, parts, dim)

    model = SparcModel.build(cfg, 5.0, None, policy=cpu_policy(D, 1))
    draws = _draws(model)
    monkeypatch.setattr(sparc_mod, "hard_indices", decide)
    monkeypatch.setattr(ShardingPolicy, "gather", gathered)
    model.frame_counts(draws[0], draws[1], noise_seed=draws[2])
    assert order == ([("argmax", 16 // D)] * D
                     + [("gather", torch.int32), ("gather", torch.int32),
                        ("gather", torch.float32)])


def _traced(fn):
    """fn() under a CPU profiler: its result and the mesh's counters."""
    prof.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, {k: v for k, v in prof.counters().items()
                 if k.startswith("mesh.")}


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("cfg", DP_CFGS, ids=DP_IDS)
def test_data_mesh_gathers_the_indices_not_beta(D, cfg, monkeypatch):
    """While tracing, `mesh.gather_bytes` of a block under a data mesh is
    the bytes of the shards but the home one's int32 indices, trace and
    iterations; `mesh.local_decisions` counts the call once and
    `mesh.beta_gathers` not at all.  Reading beta afterwards gathers it
    once: one count, and beta's bytes."""
    c = cfg
    model = SparcModel.build(cfg, 5.0, None, policy=cpu_policy(D, 1))
    draws = _draws(model)
    try:
        (_, res), counted = _traced(
            lambda: _frames_and_results(model, draws, monkeypatch))
        rest = 16 - 16 // D               # the rows off the home shard
        assert counted == {"mesh.gather_bytes": rest * (
                               c.L * 4 + c.amp_iters * 4 + 4),
                           "mesh.local_decisions": 1}
        _, read = _traced(lambda: (res.beta, res.beta))
        assert read == {"mesh.gather_bytes": rest * c.L * c.M * 4,
                        "mesh.beta_gathers": 1}
    finally:
        prof.reset()


@pytest.mark.parametrize("D", [2, 4])
def test_concat_under_a_data_mesh_gathers_beta_for_its_fold(D):
    """A concat block under a data mesh reads the whole beta of both AMP
    passes (the LLR fold of the first, the unprotected sections of the
    pinned pass): two gathers of beta a block, no decisions taken on the
    shards; a SPARC block gathers none."""
    try:
        _, counted = _traced(lambda: block(ConcatModel.build(
            CONCAT, 6.0, None, policy=cpu_policy(D, 1)), batch=8, seed=9))
        assert counted["mesh.beta_gathers"] == 2
        assert "mesh.local_decisions" not in counted
        _, counted = _traced(lambda: block(SparcModel.build(
            FUSED, 5.0, None, policy=cpu_policy(D, 1))))
        assert "mesh.beta_gathers" not in counted
        assert counted["mesh.local_decisions"] == 1
    finally:
        prof.reset()


@pytest.mark.parametrize("D,S", [(1, 2), (2, 2), (1, 4)])
def test_section_sharded_model_matches_single_device(D, S):
    """The fused route at S > 1 (K3 loop, the encode outside) and the scan
    route (collective transform) against the single device at a decisive
    point: integer counters equal."""
    for cfg in (FUSED, XLA):
        want = block(SparcModel.build(cfg, 5.0, "cpu"))
        model = SparcModel.build(cfg, 5.0, None, policy=cpu_policy(D, S))
        assert not model.enc_in_kernel
        got = block(model)
        assert {k: got[k] for k in ("bit_errors", "frame_errors",
                                    "section_errors", "trials")} == \
            {k: want[k] for k in ("bit_errors", "frame_errors",
                                  "section_errors", "trials")}
        np.testing.assert_allclose(got["tau2_final"], want["tau2_final"],
                                   rtol=2e-3)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_dist_fwht_matches_jax_and_local(S):
    x = np.random.default_rng(3).standard_normal((8, 512)).astype(np.float32)
    pol = cpu_policy(8 // S, S)
    got = dist_fwht(torch.tensor(x), pol, precision="highest")
    local = fwht_kron(torch.tensor(x), "highest")
    want = np.asarray(j_dist_fwht(jnp.asarray(x),
                                  jmesh.make_mesh(section_shards=S),
                                  precision="highest"))
    for ref in (want, local.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-3)
    twice = dist_fwht(got, pol, precision="highest")
    np.testing.assert_allclose(twice.numpy(), x * 512, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("fwht_dist", ["collective", "gspmd"])
def test_collective_fwht_model_matches_single_device(fwht_dist):
    """Either fwht_dist under a section-sharded policy runs the collective
    transform (there is no partitioner to leave it to): counters equal to
    the single device's, as tests/test_parallel.py:425-437 has it."""
    cfg = XLA.replace(fwht_dist=fwht_dist)
    want = block(SparcModel.build(XLA, 5.0, "cpu"))
    got = block(SparcModel.build(cfg, 5.0, None, policy=cpu_policy(4, 2)))
    assert_same_block(got, {k: want[k] for k in INTS if k in want})
    np.testing.assert_allclose(got["tau2_final"], want["tau2_final"],
                               rtol=1e-4)


CONCAT = ConcatConfig(
    sparc=FUSED.replace(amp_iters=10),
    ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12, bp_iters=16,
                    engine="qc", schedule="layered"),
    f_prot=0.5, feedback_iters=3)


@pytest.mark.parametrize("D,S", [(2, 1), (1, 2), (2, 2)])
def test_concat_under_a_policy_matches_single_device(D, S):
    """DP (in-kernel encode on both passes, pins cut by data shard) and a
    section-sharded inner AMP (the pins cut by section) at a decisive
    point: integer counters equal to the single device's."""
    want = block(ConcatModel.build(CONCAT, 6.0, "cpu"), batch=8, seed=9)
    model = ConcatModel.build(CONCAT, 6.0, None, policy=cpu_policy(D, S))
    assert model.sparc.enc_in_kernel == (S == 1)
    got = block(model, batch=8, seed=9)
    assert {k: got[k] for k in ("bit_errors", "frame_errors", "bp_ok",
                                "trials")} == \
        {k: want[k] for k in ("bit_errors", "frame_errors", "bp_ok",
                              "trials")}


def test_from_numpy_takes_a_policy():
    """Constants taken from elsewhere, under a (2, 2) mesh: the block of
    the model built here."""
    mb = SparcModel.build(FUSED, 5.0, "cpu")
    params = dict(p_alloc=mb.p_alloc, sq_npl=mb.sq_npl.numpy(),
                  mask=mb.op.mask.numpy(),
                  rows=np.flatnonzero(mb.op.mask.numpy()),
                  sigma2=mb.sigma2, amp_iters=mb.cfg.amp_iters)
    mt = SparcModel.from_numpy(FUSED, 5.0, params, None,
                               policy=cpu_policy(2, 2))
    assert mt.policy.mesh.shape == (2, 2) and not mt.enc_in_kernel
    got, want = block(mt), block(mb)
    assert {k: got[k] for k in ("bit_errors", "frame_errors", "trials")} \
        == {k: want[k] for k in ("bit_errors", "frame_errors", "trials")}


def test_process_rows_decode_their_share_of_the_block():
    """Two ranks' blocks (no process group needed to decode) add up to the
    one-process block: the draws do not depend on the process count."""
    want = block(SparcModel.build(XLA, 4.0, "cpu"), batch=8)
    mesh = make_mesh(1, ["cpu"])
    parts = [block(SparcModel.build(XLA, 4.0, None,
                                    policy=ShardingPolicy(mesh, r, 2)),
                   batch=8) for r in (0, 1)]
    assert all(p["trials"] == 4 for p in parts)
    for k in ("bit_errors", "frame_errors", "section_errors", "iters_sum"):
        assert parts[0][k] + parts[1][k] == want[k], k


# --------------------------------------------------------- campaign

def test_campaign_under_a_policy_runs_and_resumes(tmp_path):
    """A (2, 2) mesh's campaign equals the single device's, and a resume
    from a journal without its last block gives identical counters."""
    ccfg = CampaignConfig(ebno_grid_db=(4.0,), batch=8, min_frame_errors=2,
                          max_trials=48, base_seed=11)
    keys = ("bit_errors", "frame_errors", "trials", "blocks",
            "bit_errors_sq")
    single = run_campaign(SparcSweep(XLA, device="cpu").model_for_point,
                          ccfg, lambda m: m.cfg.k_bits, verbose=False)[0]
    sweep = SparcSweep(XLA, policy=cpu_policy(2, 2))
    assert sweep.device == torch.device("cpu")
    journal = str(tmp_path / "j.jsonl")
    res1 = run_campaign(sweep.model_for_point, ccfg, lambda m: m.cfg.k_bits,
                        journal_path=journal, policy=sweep.policy,
                        verbose=False)[0]
    assert {k: res1[k] for k in keys} == {k: single[k] for k in keys}
    lines = open(journal).read().strip().split("\n")
    with open(journal, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    res2 = run_campaign(sweep.model_for_point, ccfg, lambda m: m.cfg.k_bits,
                        journal_path=journal, policy=sweep.policy,
                        verbose=False)[0]
    assert {k: res2[k] for k in keys} == {k: res1[k] for k in keys}
    assert res2["exec_blocks"] == 1


def test_campaign_refuses_a_journal_of_another_section_axis(tmp_path):
    """S > 1 draws its noise outside the kernel and decodes in the sharded
    loop, so its blocks are stamped with section_shards; a resume with
    another section axis raises instead of mixing the two streams."""
    ccfg = CampaignConfig(ebno_grid_db=(4.0,), batch=8, min_frame_errors=2,
                          max_trials=16, base_seed=11)
    journal = str(tmp_path / "j.jsonl")

    def run(S):
        sweep = SparcSweep(XLA, device="cpu") if S == 1 else SparcSweep(
            XLA, policy=cpu_policy(1, S))
        return run_campaign(sweep.model_for_point, ccfg,
                            lambda m: m.cfg.k_bits, journal_path=journal,
                            policy=sweep.policy, verbose=False)[0]

    run(2)
    lines = [json.loads(x) for x in open(journal).read().split("\n") if x]
    assert lines and all(x["section_shards"] == 2 for x in lines)
    for S in (1, 4):
        with pytest.raises(ValueError, match="section_shards=2, this run"):
            run(S)
    assert run(2)["exec_blocks"] == 0      # the same axis resumes
    journal = str(tmp_path / "j1.jsonl")
    run(1)
    assert all("section_shards" not in json.loads(x)
               for x in open(journal).read().split("\n") if x)
    with pytest.raises(ValueError, match="section_shards=1, this run"):
        run(2)


def test_run_point_takes_a_policy():
    pol = cpu_policy(2, 1)
    model = SparcModel.build(XLA, 8.0, None, policy=pol)
    tot = run_point(model.run_block, 0, batch=8, min_frame_errors=1,
                    max_trials=16, policy=pol, pipelined=False)
    assert tot["trials"] == 16 and tot["frame_errors"] == 0
    with pytest.raises(ValueError, match="divisible"):
        run_point(model.run_block, 0, batch=7, min_frame_errors=1,
                  max_trials=16, policy=pol)


# --------------------------------------------------------------- CLI

def test_cli_section_shards_run_on_a_virtual_cpu_mesh(tmp_path):
    recs = {}
    for S in ("1", "2"):
        out = tmp_path / f"s{S}.jsonl"
        assert tcli.main(["campaign", "--preset", "plain_small", "--cpu",
                          "--ebno", "4.0", "--batch", "2", "--max-trials",
                          "4", "--amp-iters", "8", "--section-shards", S,
                          "--out", str(out)]) == 0
        recs[S] = json.loads(out.read_text().splitlines()[-1])
    assert recs["2"]["mesh"] == [1, 2] and recs["2"]["processes"] == 1
    assert "mesh" not in recs["1"]
    for k in ("bit_errors", "frame_errors", "trials", "blocks"):
        assert recs["2"][k] == recs["1"][k], k
    with pytest.raises(SystemExit, match="power of two"):
        tcli.main(["campaign", "--preset", "plain_small", "--cpu",
                   "--section-shards", "3"])


def test_cli_mesh_spans_every_gpu_of_the_process(monkeypatch):
    """Four visible GPUs (stood in for here): one process drives all four,
    a D x S mesh of them; under --distributed each process drives its
    LOCAL_RANK share, and processes that outnumber the GPUs share them;
    processes that would leave GPUs idle exit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    gpus = tcli._process_gpus(False)
    assert gpus == [torch.device("cuda", i) for i in range(4)]
    assert make_mesh(2, gpus).shape == (2, 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tcli._process_gpus(True) == [torch.device("cuda", 2),
                                        torch.device("cuda", 3)]
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert tcli._process_gpus(True) == [torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="2 processes cannot share 3 GPUs"):
        tcli._process_gpus(True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(SystemExit, match="needs --distributed"):
        tcli.main(["campaign", "--preset", "concat", "--section-shards",
                   "2"])


def test_distributed_without_its_environment_exits(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        tcli.main(["campaign", "--preset", "plain_small", "--cpu",
                   "--distributed"])


# ------------------------------------------------------------ dry run

def test_dryrun_multichip_runs_the_eight_paths(capsys):
    from sparc_ldpc_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    dryrun_multichip(8)
    lines = [x for x in capsys.readouterr().out.splitlines() if "OK" in x]
    assert len(lines) == 8, lines
