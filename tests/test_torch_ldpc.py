"""The port's LDPC code, BP engines and layered-kernel wrapper against the
JAX reference on the CPU.  The CUDA kernel is held against its plain
version in tests/test_torch_cuda.py and, on real concat LLRs, by
chip_smoke.py.

Contracts: exact for the code's matrices and the encoder; bitwise for
min-sum and offset min-sum (hard decisions, ok flags, iteration counts and
float32 posteriors), on every engine; decisions against the float64 twin.
Sum-product goes through tanh and log, whose float32 implementations
differ between XLA's CPU backend and PyTorch (XLA's tanh is a rational
approximation that reaches exactly 1.0 at |x| = 7.9988, PyTorch's at
9.01).  Once messages saturate, phi of a saturated message is 0 on one
side and about 1e-7 on the other, and the 1e-7 floor of phi's argument
turns that into O(1) differences, so SPA is held to rtol 1e-5 before the
messages saturate (two iterations on noisy LLRs), and to decisions after.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

import jax.numpy as jnp

from sparc_ldpc_tpu.config import LdpcConfig
from sparc_ldpc_tpu.design.ldpc_codes import build_code, qc_structure
from sparc_ldpc_tpu.models.ldpc import LdpcModel as JLdpc
from sparc_ldpc_tpu.ops.bp import BpTables as JBpTables
from sparc_ldpc_tpu.ops.bp import bp_decode as j_bp_decode
from sparc_ldpc_tpu.ops.bp_qc import QcBpTables as JQcTables
from sparc_ldpc_tpu.ops.bp_qc import bp_decode_qc as j_bp_decode_qc
from sparc_ldpc_tpu.ops.bp_qc_pallas import bp_decode_qc_pallas

from sparc_ldpc_tpu_torch.models.ldpc import LdpcModel
from sparc_ldpc_tpu_torch.ops.bp import BpTables, bp_decode
from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import (
    address_table, bp_decode_qc_kernel, layer_table)

# the array code at a test size, the three concat presets' outer codes and
# the 802.11n n=1296 code (Z = 54)
CODES = {
    "array13": LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12),
    "array31": LdpcConfig(kind="array", z=31, rows_b=4, cols_b=24),
    "wifi648": LdpcConfig(kind="qc", path="wifi_n648_r12"),
    "r56": LdpcConfig(kind="qc", path="qc_n648_r56"),
    "wifi1296": LdpcConfig(kind="qc", path="wifi_n1296_r12"),
}
PRESET_CODES = ["array31", "wifi648", "r56", "wifi1296"]
FIELDS = ("hard", "ok", "iters", "posterior")


def _llrs(cfg, B, sigma, seed):
    """Noisy BPSK LLRs of random codewords (NumPy, float32)."""
    code = build_code(cfg)
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (B, code.k)))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, code.n))
    return code, cw, (2.0 * y / sigma ** 2).astype(np.float32)


def _shifts(cfg):
    shifts, Z = qc_structure(cfg)
    return tuple(tuple(int(s) for s in row) for row in shifts), Z


def _assert_bitwise(rt, rj):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)


# ------------------------------------------------------------------ code

@pytest.mark.parametrize("name", PRESET_CODES)
def test_ldpc_model_matches_jax_exactly(name):
    cfg = CODES[name].replace(engine="qc", schedule="layered")
    mj, mt = JLdpc.build(cfg), LdpcModel.build(cfg, "cpu")
    assert (mt.n, mt.k) == (mj.n, mj.k)
    np.testing.assert_array_equal(mt.G.numpy(), np.asarray(mj.G))
    np.testing.assert_array_equal(mt.H.numpy(), np.asarray(mj.H))
    np.testing.assert_array_equal(mt.msg_pos.numpy(), np.asarray(mj.msg_pos))
    assert mt.qc_shifts == mj.qc_shifts
    assert mt.qc_tables.Z == mj.qc_tables.Z
    for f in ("gather_cv", "gather_vc", "block_mask"):
        np.testing.assert_array_equal(getattr(mt.qc_tables, f).numpy(),
                                      np.asarray(getattr(mj.qc_tables, f)))
    for f in ("check_nbr", "check_mask", "var_edge", "var_mask"):
        np.testing.assert_array_equal(getattr(mt.tables, f).numpy(),
                                      np.asarray(getattr(mj.tables, f)))


@pytest.mark.parametrize("name", PRESET_CODES)
def test_encode_is_exact(name):
    cfg = CODES[name]
    mj, mt = JLdpc.build(cfg), LdpcModel.build(cfg, "cpu")
    u = np.random.default_rng(1).integers(0, 2, (5, mt.k)).astype(np.int32)
    cw = mt.encode(torch.tensor(u)).numpy()
    np.testing.assert_array_equal(cw, np.asarray(mj.encode(jnp.asarray(u))))
    assert not np.any((cw @ mt.code.H.T.astype(np.int64)) % 2)
    np.testing.assert_array_equal(
        mt.extract_message(torch.tensor(cw)).numpy(), u)


# --------------------------------------------------------------- engines

@pytest.mark.parametrize("engine", ["flooding", "layered", "edge"])
@pytest.mark.parametrize("method", ["minsum", "oms"])
@pytest.mark.parametrize("name", PRESET_CODES)
def test_bp_bitwise_vs_jax(name, method, engine):
    cfg = CODES[name]
    code, _, llr = _llrs(cfg, B=6, sigma=0.75, seed=2)
    kw = dict(iters=16, method=method)
    if engine == "edge":
        rj = j_bp_decode(jnp.asarray(llr), JBpTables.build(code), **kw)
        rt = bp_decode(torch.tensor(llr), BpTables.build(code), **kw)
    else:
        shifts, Z = qc_structure(cfg)
        rj = j_bp_decode_qc(jnp.asarray(llr), JQcTables.build(shifts, Z),
                            schedule=engine, **kw)
        rt = bp_decode_qc(torch.tensor(llr), QcBpTables.build(shifts, Z),
                          schedule=engine, **kw)
    _assert_bitwise(rt, rj)
    assert rt.hard.dtype == torch.uint8 and rt.ok.dtype == torch.bool


@pytest.mark.parametrize("engine", ["flooding", "layered", "edge"])
@pytest.mark.parametrize("name", PRESET_CODES)
def test_spa_matches_jax(name, engine):
    cfg = CODES[name]
    code, _, llr = _llrs(cfg, B=6, sigma=1.1, seed=3)
    shifts, Z = qc_structure(cfg)

    def run(iters):
        kw = dict(iters=iters, method="spa")
        if engine == "edge":
            return (j_bp_decode(jnp.asarray(llr), JBpTables.build(code),
                                **kw),
                    bp_decode(torch.tensor(llr), BpTables.build(code), **kw))
        return (j_bp_decode_qc(jnp.asarray(llr), JQcTables.build(shifts, Z),
                               schedule=engine, **kw),
                bp_decode_qc(torch.tensor(llr), QcBpTables.build(shifts, Z),
                             schedule=engine, **kw))

    rj, rt = run(2)
    np.testing.assert_allclose(rt.posterior.numpy(), np.asarray(rj.posterior),
                               rtol=1e-5, atol=1e-5)
    for f in ("hard", "ok", "iters"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    code, cw, llr = _llrs(cfg, B=6, sigma=0.6, seed=4)
    rj, rt = run(16)
    for f in ("hard", "ok", "iters"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))


@pytest.mark.parametrize("name,method", [
    ("array13", "minsum"), ("array13", "oms"), ("wifi648", "minsum")])
def test_kernel_route_bitwise_vs_jax_pallas_kernel(name, method):
    """The layered kernel's wrapper on the CPU (its plain version) against
    the reference's Pallas kernel in interpret mode."""
    cfg = CODES[name]
    _, _, llr = _llrs(cfg, B=4, sigma=0.7, seed=5)
    shifts, Z = _shifts(cfg)
    rj = bp_decode_qc_pallas(jnp.asarray(llr), shifts, Z, iters=8,
                             method=method, interpret=True)
    rt = bp_decode_qc_kernel(torch.tensor(llr), shifts, Z, iters=8,
                             method=method)
    _assert_bitwise(rt, rj)


@pytest.mark.parametrize("method", ["minsum", "oms"])
@pytest.mark.parametrize("name", ["array13", "wifi648", "r56"])
def test_layered_decisions_match_float64_twin(name, method):
    """Decisions of the float32 layered engine against the reference's
    float64 twin oracle.ldpc.bp_decode_layered, frame by frame: the same
    ok flags, and on the frames that decode the same codeword after the
    same number of iterations (a frame that does not decode wanders, and
    float32 and float64 wander apart)."""
    from sparc_ldpc_tpu.oracle.ldpc import bp_decode_layered

    cfg = CODES[name]
    # rate 5/6 needs a cleaner channel than rate 1/2 to decode
    sigma = 0.45 if name == "r56" else 0.6
    code, cw, llr = _llrs(cfg, B=6, sigma=sigma, seed=6)
    shifts, Z = qc_structure(cfg)
    rt = bp_decode_qc(torch.tensor(llr), QcBpTables.build(shifts, Z),
                      iters=24, method=method, schedule="layered")
    for b in range(llr.shape[0]):
        hard, _, it = bp_decode_layered(llr[b].astype(np.float64), code,
                                        shifts, Z, iters=24, method=method)
        ok = not np.any(code.syndrome(hard))
        assert bool(rt.ok[b]) == ok
        if ok:
            np.testing.assert_array_equal(rt.hard[b].numpy(), hard)
            assert int(rt.iters[b]) == it
    assert rt.ok.sum() >= 3


# -------------------------------------------------------------- wrapper

def test_layer_table_lists_blocks_per_layer():
    shifts = ((0, -1, 3), (-1, 2, 1))
    lt = layer_table(shifts)
    assert (lt.n_act, lt.n_zero) == (4, 2)
    assert lt.table.tolist() == [0, 2, 4,          # layer starts
                                 0, 1, 2,          # zero-block starts
                                 1, 0,             # zero-block columns
                                 0, 1, 2,          # reduced starts
                                 1, 0]             # reduced columns
    assert lt.degrees == (2, 2) and lt.max_degree == 2
    assert (lt.lanes, lt.slots) == (1, 8)
    assert lt.reduced == ((0, 1), (1, 0))
    # layer 0 reads blocks 0 (shift 0) and 2 (shift 3), layer 1 blocks 1
    # (shift 2) and 2 (shift 1); Z = 4, n = 12, padding n + t
    addr = address_table(shifts, 4)
    assert addr.shape == (2, 2, 4, 4) and addr.dtype == np.int32
    t = np.arange(4)
    for j, cols in enumerate([[t, 8 + (t + 3) % 4],
                              [4 + (t + 2) % 4, 8 + (t + 1) % 4]]):
        slots = addr[j].transpose(0, 2, 1).reshape(8, 4)  # (slot, t)
        for i in range(8):
            want = cols[i] if i < 2 else 12 + t
            assert slots[i].tolist() == list(want), (j, i)


def _replay_zero_passes(shifts, iters=4):
    """Brute force: the (layer, column) zero blocks at which clip(y) + 0
    can change a value, iteration by iteration.  A column is dirty from
    the start (a -0.0 LLR) and after every active layer's write, clean
    after a zero block's clip; iteration 0 clips at every zero block."""
    s = np.asarray(shifts)
    J, K = s.shape
    dirty = np.ones(K, dtype=bool)
    needed = []
    for it in range(iters):
        hits = set()
        for j in range(J):
            for k in range(K):
                if s[j, k] >= 0:
                    dirty[k] = True
                elif it == 0 or dirty[k]:
                    if dirty[k]:
                        hits.add((j, k))
                    dirty[k] = False
        needed.append(hits)
    return needed


@pytest.mark.parametrize("name", ["array13", "array31", "wifi648", "r56",
                                  "wifi1296", "wifi_n1944_r12",
                                  "qc_n648_r23", "qc_n648_r34"])
def test_layer_table_degrees_and_reduced_zero_list(name):
    cfg = CODES.get(name) or LdpcConfig(kind="qc", path=name)
    shifts, Z = _shifts(cfg)
    s = np.asarray(shifts)
    lt = layer_table(shifts)
    assert lt.degrees == tuple(int(d) for d in (s >= 0).sum(1))
    assert lt.n_act == sum(lt.degrees) and lt.n_zero == int((s < 0).sum())
    needed = _replay_zero_passes(shifts)
    # every later iteration needs the same passes, and the list has them
    for hits in needed[1:]:
        assert hits == set(lt.reduced)
    assert needed[0] >= set(lt.reduced)
    J = s.shape[0]
    tab = lt.table
    red_start = tab[-(len(lt.reduced) + J + 1):][:J + 1]
    red_k = tab[len(tab) - len(lt.reduced):]
    assert tab[:J + 1].tolist() == np.cumsum((0,) + lt.degrees).tolist()
    # every check's addresses: its active blocks' words in column order,
    # then its own scratch word, lane r of the check holding edges
    # r slots .. (r + 1) slots - 1
    addr = address_table(shifts, Z)
    K, L, S = s.shape[1], lt.lanes, lt.slots
    assert addr.shape == (J, S // 4, Z * L, 4)
    assert (L, S) == next(ls for ls in ((1, 8), (1, 12), (2, 8), (2, 12),
                                        (2, 16))
                          if ls[0] * ls[1] >= lt.max_degree)
    for j in range(J):
        ks = np.flatnonzero(s[j] >= 0)
        for t in range(Z):
            got = [int(addr[j, m // 4, t * L + r, m % 4])
                   for r in range(L) for m in range(S)]
            want = [k * Z + (t + s[j, k]) % Z for k in ks]
            assert got == want + [K * Z + t] * (L * S - len(ks))


def test_layer_table_refuses_more_than_32_active_blocks():
    layer_table(((0,) * 32, (-1,) * 32))
    with pytest.raises(ValueError, match="at most 32"):
        layer_table(((0,) * 33, (-1,) * 33))


def test_kernel_wrapper_on_cpu_runs_the_plain_version_without_launch():
    cfg = CODES["wifi648"]
    _, _, llr = _llrs(cfg, B=3, sigma=0.7, seed=7)
    shifts, Z = _shifts(cfg)
    launches = bp_decode_qc_kernel.launches
    rk = bp_decode_qc_kernel(torch.tensor(llr), shifts, Z, iters=6)
    rp = bp_decode_qc(torch.tensor(llr), QcBpTables.build(np.asarray(shifts),
                                                         Z),
                      iters=6, schedule="layered")
    assert bp_decode_qc_kernel.launches == launches
    for f in FIELDS:
        assert torch.equal(getattr(rk, f), getattr(rp, f))


def test_kernel_wrapper_rejects_what_it_cannot_take():
    shifts, Z = _shifts(CODES["array13"])
    llr = torch.zeros((2, 12 * Z))
    with pytest.raises(TypeError):
        bp_decode_qc_kernel(llr.double(), shifts, Z)
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr[:, 1:], shifts, Z)
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr[0], shifts, Z)
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr, shifts, Z, method="spa")
    with pytest.raises(ValueError):
        bp_decode_qc_kernel(llr.to("meta"), shifts, Z)
    assert bp_decode_qc_kernel.launches == 0


@pytest.mark.parametrize("engine,schedule", [
    ("qc", "layered"), ("qc", "flooding"), ("qc_xla", "layered"),
    ("auto", "flooding"), ("edge", "flooding")])
def test_model_decode_routes_like_jax(engine, schedule):
    cfg = CODES["array13"].replace(engine=engine, schedule=schedule,
                                   bp_iters=12)
    _, cw, llr = _llrs(cfg, B=4, sigma=0.5, seed=8)
    rj = JLdpc.build(cfg).decode(jnp.asarray(llr))
    rt = LdpcModel.build(cfg, "cpu").decode(torch.tensor(llr))
    _assert_bitwise(rt, rj)
    assert rt.ok.all()
    np.testing.assert_array_equal(rt.hard.numpy(), cw)
