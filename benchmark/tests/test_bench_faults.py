"""`correct` comes out false when the timed path is broken, and for the
control.

The runs skip the look for a card and drive the rest of a run on the CPU
(window, capture, reference, comparison) on the small cells of
benchmark/tests/tiny.py, with each cell's limits.  At 6.0 dB every frame of
a sound run decodes on both sides, so a sound run passes; each fault that a
cell can have is planted in the program underneath the run:

- a step that returns its state unchanged: AMP's beta stays at its start;
- half the batch left out: the first half of the codewords decoded and
  taken for the whole block;
- the exchange between cards left out (the data mesh): the other cards'
  parts of beta never reach the home card;
- an answer altered where it is produced: section 0's decision moved by
  one in every frame; in the concatenated code also BP's: the first
  message bit of every decoded LDPC codeword flipped, its syndrome
  verdict kept.
"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

import benchmark.run as run
from benchmark.harness import spec
from benchmark.reference import compare
from benchmark.tests.tiny import write_tiny

SEED = 2 ** 31 + 99


@pytest.fixture
def cells(tmp_path, monkeypatch):
    def make(ebno_db):
        d = write_tiny(tmp_path / f"e{ebno_db}", ebno_db)
        monkeypatch.setattr(spec, "ROOT", d)
        monkeypatch.setattr(spec, "BENCH_DIR", d)
        return d
    return make


def one_run(cell: str):
    devices = ["cpu", "cpu"] if cell.endswith("dp16") else ["cpu"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.3", "--trace", "0"], devices=devices)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def state_unchanged(monkeypatch):
    from sparc_ldpc_tpu_torch.ops import amp_kernel

    orig = amp_kernel.amp_fused_reference

    def broken(*a, **kw):
        beta, trace, iters = orig(*a, **kw)
        return torch.zeros_like(beta), trace, iters

    monkeypatch.setattr(amp_kernel, "amp_fused_reference", broken)


def half_batch(monkeypatch):
    from sparc_ldpc_tpu_torch.ops import amp_kernel

    orig = amp_kernel.amp_fused_reference

    def half(t, h):
        return None if t is None else t[:h]

    def broken(y_n, mask, sq_npl, P, n, T, encode_idx=None, *rest, **kw):
        B = encode_idx.shape[0]
        h = B // 2
        for k in ("noise_seed", "pin_idx"):
            if k in kw:
                kw[k] = half(kw[k], h)
        rest = list(rest)
        # positional: precision, tol, pin_idx, tau2_schedule, noise_seed
        for i in (2, 4):
            if len(rest) > i:
                rest[i] = half(rest[i], h)
        beta, trace, iters = orig(half(y_n, h), mask, sq_npl, P, n, T,
                                  half(encode_idx, h), *rest, **kw)
        return (torch.cat([beta, beta]), torch.cat([trace, trace], 1),
                torch.cat([iters, iters]))

    monkeypatch.setattr(amp_kernel, "amp_fused_reference", broken)


def exchange_left_out(monkeypatch):
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy

    def broken(self, parts, dim):
        home = parts[0].to(self.home)
        return torch.cat([home] + [torch.zeros_like(home)
                                   for _ in parts[1:]], dim)

    monkeypatch.setattr(ShardingPolicy, "gather", broken)


def answer_altered(monkeypatch):
    from sparc_ldpc_tpu_torch.models import concat, sparc

    orig = sparc.hard_indices

    def broken(beta):
        idx = orig(beta).clone()
        idx[:, 0] = (idx[:, 0] + 1) % beta.shape[-1]
        return idx

    monkeypatch.setattr(sparc, "hard_indices", broken)
    monkeypatch.setattr(concat, "hard_indices", broken)


def bp_answer_altered(monkeypatch):
    from sparc_ldpc_tpu_torch.models.ldpc import LdpcModel

    orig = LdpcModel.decode

    def broken(self, llr, iters=None):
        res = orig(self, llr, iters)
        hard = res.hard.clone()
        hard[:, self.msg_pos[0]] ^= 1
        return res._replace(hard=hard)

    monkeypatch.setattr(LdpcModel, "decode", broken)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
CELLS = ("tiny_sparc.t16", "tiny_concat.t16")


@pytest.mark.parametrize("cell", CELLS + ("tiny_sparc.dp16",))
def test_sound_runs_are_correct(cells, cell):
    cells(6.0)
    assert one_run(cell)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cells, monkeypatch, cell, fault):
    cells(6.0)
    FAULTS[fault](monkeypatch)
    assert one_run(cell)["correct"] is False


def test_bp_answer_altered_is_not_correct(cells, monkeypatch):
    cells(6.0)
    bp_answer_altered(monkeypatch)
    assert one_run("tiny_concat.t16")["correct"] is False


def test_the_exchange_left_out_is_not_correct(cells, monkeypatch):
    cells(6.0)
    exchange_left_out(monkeypatch)
    assert one_run("tiny_sparc.dp16")["correct"] is False


@pytest.mark.parametrize("cell,ebno_db", [("tiny_sparc.t16", 2.0),
                                          ("tiny_concat.t16", 3.0)])
def test_the_control_is_not_correct(cells, cell, ebno_db):
    """The reference in the program's place, its transforms' operands in
    float8 e4m3 (the precision below the configuration's bfloat16), fails
    the cell's limits against the reference, at the Eb/N0 of the
    benchmark's cell of that configuration."""
    cells(ebno_db)
    c = spec.cell(cell, spec.benchmark())
    cfg, tr = c["config_file"], c["traffic_file"]
    sysmod = spec.system(cfg["system"])
    ref = sysmod.System.reference(cfg, tr["ebno_db"], "cpu", "bf16")
    ctrl = ref.with_rounding("fp8")
    a = [ctrl.frames(SEED, 0, b, 64, "cpu") for b in range(2)]
    r = [ref.frames(SEED, 0, b, 64, "cpu") for b in range(2)]
    import numpy as np

    cat = {k: np.concatenate([x[k] for x in a]) for k in a[0]}
    rcat = {k: np.concatenate([x[k] for x in r]) for k in r[0]}
    values = compare.numbers(cat, rcat)
    assert not compare.verdict(values, c["check_file"]["limits"])
