"""The port's own configuration, design code and QC data
(sparc_ldpc_tpu_torch/config.py, design/, data/) against the reference's,
exactly; the port's import boundary; and the entry points that run on the
card unless the caller passes a device.

The copies must agree bit for bit: a config's repr, and with it its
config_hash, is the reference's, so a campaign journal written by either
package resumes in the other, and the design constants (power allocation,
state evolution, operator rows, LDPC codes) define the code itself.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu import config as jconfig
from sparc_ldpc_tpu.design import codebook as jcodebook
from sparc_ldpc_tpu.design import ldpc_codes as jldpc
from sparc_ldpc_tpu.design import power as jpower
from sparc_ldpc_tpu.design import se as jse
from sparc_ldpc_tpu.utils.provenance import config_hash as j_config_hash

import sparc_ldpc_tpu_torch as slt
from sparc_ldpc_tpu_torch import config as tconfig
from sparc_ldpc_tpu_torch.design import codebook as tcodebook
from sparc_ldpc_tpu_torch.design import ldpc_codes as tldpc
from sparc_ldpc_tpu_torch.design import power as tpower
from sparc_ldpc_tpu_torch.design import se as tse
from sparc_ldpc_tpu_torch.utils.provenance import config_hash

REPO = Path(__file__).resolve().parents[1]


def twin(cfg):
    """The port's config equal to a reference config (nested for
    ConcatConfig)."""
    if isinstance(cfg, jconfig.ConcatConfig):
        return tconfig.ConcatConfig(
            sparc=twin(cfg.sparc), ldpc=twin(cfg.ldpc), f_prot=cfg.f_prot,
            feedback_iters=cfg.feedback_iters)
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**dataclasses.asdict(cfg))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_is_the_reference_preset(name):
    ref, port = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert type(port).__module__ == "sparc_ldpc_tpu_torch.config"
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert repr(port) == repr(ref)
    assert config_hash(port) == j_config_hash(ref)
    assert port == twin(ref)
    assert slt.PRESETS[name] is port


@pytest.mark.parametrize("cls,kw", [
    ("SparcConfig", dict(M=100)),
    ("SparcConfig", dict(power_alloc="linear")),
    ("SparcConfig", dict(op_kind="fft")),
    ("SparcConfig", dict(tau_mode="oracle")),
    ("SparcConfig", dict(transform_precision="fp8")),
    ("SparcConfig", dict(fwht_scheme="radix4")),
    ("SparcConfig", dict(fwht_dist="ring")),
    ("SparcConfig", dict(amp_residual_space="m")),
    ("SparcConfig", dict(amp_kernel="fused_mono")),
    ("LdpcConfig", dict(kind="turbo")),
    ("LdpcConfig", dict(decoder="bitflip")),
    ("LdpcConfig", dict(engine="gpu")),
    ("LdpcConfig", dict(schedule="serial")),
    ("LdpcConfig", dict(schedule="layered", engine="edge")),
])
def test_invalid_config_raises_the_reference_error(cls, kw):
    with pytest.raises(ValueError) as ref:
        getattr(jconfig, cls)(**kw)
    with pytest.raises(ValueError) as port:
        getattr(tconfig, cls)(**kw)
    assert str(port.value) == str(ref.value)


def test_config_properties_match():
    for name, ref in jconfig.PRESETS.items():
        if not isinstance(ref, jconfig.SparcConfig):
            continue
        port = tconfig.PRESETS[name]
        for prop in ("logM", "k_bits", "n", "ML"):
            assert getattr(port, prop) == getattr(ref, prop)
        assert port.sigma2(2.5) == ref.sigma2(2.5)
        assert port.ebno_db(0.3) == ref.ebno_db(0.3)
        assert repr(port.replace(L=64)) == repr(ref.replace(L=64))


# ------------------------------------------------------------- design

@pytest.mark.parametrize("kind", ["flat", "exp", "modified", "iterative"])
def test_power_allocation_matches(kind):
    """All four kinds; "modified" with its (a, f) given (the search over
    them runs minutes)."""
    cfg = tconfig.SparcConfig(L=64, M=64, R=1.0, power_alloc=kind)
    args = (kind, cfg.L, cfg.P, cfg.sigma2(2.0), cfg.n, cfg.M)
    if kind == "modified":
        args += (0.6, 0.8)
    np.testing.assert_array_equal(tpower.power_allocation(*args),
                                  jpower.power_allocation(*args))


def test_state_evolution_matches():
    cfg = tconfig.SparcConfig(L=64, M=64, R=1.0)
    sigma2 = cfg.sigma2(3.0)
    p = tpower.power_allocation("iterative", cfg.L, cfg.P, sigma2, cfg.n,
                                cfg.M)
    for method in ("mc", "quad"):
        kw = dict(T=20, n_samples=512, method=method)
        np.testing.assert_array_equal(
            tse.se_trajectory(p, cfg.n, cfg.M, sigma2, **kw),
            jse.se_trajectory(p, cfg.n, cfg.M, sigma2, **kw))
    assert tse.se_converged_iters(p, cfg.n, cfg.M, sigma2, T_max=32) == \
        jse.se_converged_iters(p, cfg.n, cfg.M, sigma2, T_max=32)
    U = np.random.default_rng(0).standard_normal((256, cfg.M))
    nu = np.linspace(0.5, 6.0, 11)
    np.testing.assert_array_equal(tse.se_section_success(nu, U),
                                  jse.se_section_success(nu, U))


@pytest.mark.parametrize("n,ML,seed,col_signs", [
    (1024, 4096, 0, False), (36864, 2 ** 21, 0, False),
    (6827, 65536, 3, True)])
def test_hadamard_plan_matches(n, ML, seed, col_signs):
    a = tcodebook.hadamard_plan(n, ML, seed, col_signs)
    b = jcodebook.hadamard_plan(n, ML, seed, col_signs)
    assert (a.N, a.n, a.ML) == (b.N, b.n, b.ML)
    np.testing.assert_array_equal(a.rows, b.rows)
    if col_signs:
        np.testing.assert_array_equal(a.signs, b.signs)
    else:
        assert a.signs is None and b.signs is None


QC_FILES = sorted(p.stem for p in (REPO / "sparc_ldpc_tpu/data").glob("*.qc"))


def test_the_port_carries_every_qc_file():
    port = sorted(p.stem for p in
                  (REPO / "sparc_ldpc_tpu_torch/data").glob("*.qc"))
    assert port == QC_FILES and len(QC_FILES) == 6
    for stem in QC_FILES:
        assert (REPO / f"sparc_ldpc_tpu_torch/data/{stem}.qc").read_bytes() \
            == (REPO / f"sparc_ldpc_tpu/data/{stem}.qc").read_bytes()


@pytest.mark.parametrize("spec", [
    dict(kind="array", z=31, rows_b=4, cols_b=24),
    *[dict(kind="qc", path=stem) for stem in QC_FILES]])
def test_ldpc_code_matches(spec):
    tc, jc = tconfig.LdpcConfig(**spec), jconfig.LdpcConfig(**spec)
    a, b = tldpc.build_code(tc), jldpc.build_code(jc)
    assert (a.n, a.k) == (b.n, b.k)
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f.name
    (sa, za), (sb, zb) = tldpc.qc_structure(tc), jldpc.qc_structure(jc)
    assert za == zb
    np.testing.assert_array_equal(sa, sb)


# ---------------------------------------------------- import boundary

def test_port_imports_nothing_of_the_reference():
    """Every module of the port, with the design code run: no module of
    JAX and none of the reference package is loaded."""
    code = (
        "import pkgutil, sys\n"
        "import sparc_ldpc_tpu_torch as slt\n"
        "for m in pkgutil.walk_packages(slt.__path__, 'sparc_ldpc_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from sparc_ldpc_tpu_torch.design.ldpc_codes import build_code\n"
        "build_code(slt.LdpcConfig(kind='qc', path='wifi_n648_r12'))\n"
        "from sparc_ldpc_tpu_torch.models.sparc import SparcModel\n"
        "SparcModel.build(slt.PRESETS['plain_small'].replace(L=32, M=64), "
        "4.0, 'cpu')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'sparc_ldpc_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------ entry points and devices

def _ldpc():
    from sparc_ldpc_tpu_torch.models.ldpc import LdpcModel

    cfg = tconfig.LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                             engine="qc", schedule="layered", bp_iters=4)
    return LdpcModel.build, (cfg,)


def _sparc_sweep():
    from sparc_ldpc_tpu_torch.models.sparc import SparcSweep

    return SparcSweep, (tconfig.SparcConfig(L=32, M=64, R=1.0),)


def _concat_sweep():
    from sparc_ldpc_tpu_torch.models.concat import ConcatSweep

    return ConcatSweep, (tconfig.PRESETS["concat"],)


def _run_point():
    from sparc_ldpc_tpu_torch.parallel.campaign import run_point

    def run_block(gen, batch):
        bits = torch.randint(0, 2, (batch,), generator=gen,
                             device=gen.device)
        return dict(trials=torch.tensor(batch), frame_errors=bits.sum(),
                    bit_errors=bits.sum())

    return run_point, (run_block, 0, 4, 10 ** 6, 8)


@pytest.mark.parametrize("entry", [_ldpc, _sparc_sweep, _concat_sweep,
                                   _run_point])
def test_entry_point_runs_on_the_card_unless_told(entry):
    fn, args = entry()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args)
    out = fn(*args, device="cpu")
    assert out is not None
