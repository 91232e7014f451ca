"""The port's campaign driver (sparc_ldpc_tpu_torch.parallel.campaign) on
the CPU: the semantics of the reference's tests/test_parallel.py campaign
tests (resume, the pipelined block count, when bits/s exists), and the
journal and provenance helpers against the reference's.

The port's blocks draw from torch generators, not the reference's key
tree, so counters are compared within the port; the accounting rules are
the reference's.
"""

import json
import time

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu.config import PRESETS, CampaignConfig, SparcConfig
from sparc_ldpc_tpu.utils import io as jio
from sparc_ldpc_tpu.utils import provenance as jprov

from sparc_ldpc_tpu_torch.models.sparc import SparcModel, SparcSweep
from sparc_ldpc_tpu_torch.parallel.campaign import (
    run_campaign, run_point, steady_bits_per_s)
from sparc_ldpc_tpu_torch.utils import io as tio
from sparc_ldpc_tpu_torch.utils import profiling as tprof
from sparc_ldpc_tpu_torch.utils import provenance as tprov

# the fused route (K1's plain version here) with the adaptive stop, and
# the scan route
SPLIT = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=16,
                    amp_tol=1e-4, amp_kernel="fused_split",
                    transform_precision="bf16")
XLA = SparcConfig(L=32, M=64, R=1.0, op_kind="hadamard", amp_iters=12)


def _kb(m):
    return m.cfg.k_bits


@pytest.fixture(scope="module")
def split_model():
    return SparcModel.build(SPLIT, 6.0, "cpu")


def test_campaign_runs_and_resumes(tmp_path):
    """Dropping the journal's last block and running again gives identical
    final counters."""
    ccfg = CampaignConfig(ebno_grid_db=(5.0,), batch=8, min_frame_errors=2,
                          max_trials=64, base_seed=11)
    model = SparcModel.build(XLA, 5.0, "cpu")
    journal = str(tmp_path / "journal.jsonl")
    res1 = run_campaign(lambda e: model, ccfg, _kb, journal_path=journal,
                        verbose=False)
    lines = open(journal).read().strip().split("\n")
    assert len(lines) == res1[0]["exec_blocks"] >= 2
    with open(journal, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    res2 = run_campaign(lambda e: model, ccfg, _kb, journal_path=journal,
                        verbose=False)
    for k in ("bit_errors", "frame_errors", "trials", "blocks",
              "bit_errors_sq"):
        assert res1[0][k] == res2[0][k], k
    assert res2[0]["exec_blocks"] == 1 and res2[0]["bits_per_s"] is None


def test_campaign_refuses_a_journal_of_another_draw_device(tmp_path):
    """A CUDA and a CPU generator seeded alike draw different bits and
    noise, so every journal line records the device type of its draws and
    a resume on another device type is refused, with both named; a line
    without the field (the reference's, or an older port journal's)
    resumes as before."""
    ccfg = CampaignConfig(ebno_grid_db=(5.0,), batch=8, min_frame_errors=2,
                          max_trials=64, base_seed=11)
    model = SparcModel.build(XLA, 5.0, "cpu")
    journal = tmp_path / "journal.jsonl"
    res1 = run_campaign(lambda e: model, ccfg, _kb, journal_path=str(journal),
                        verbose=False)
    lines = [json.loads(x) for x in journal.read_text().split("\n") if x]
    assert lines and all(x["draw_device"] == "cpu" for x in lines)
    # the same journal as if its blocks had drawn on a card
    journal.write_text("".join(json.dumps(dict(x, draw_device="cuda")) + "\n"
                               for x in lines))
    with pytest.raises(ValueError, match="draw_device='cuda'.*'cpu'"):
        run_campaign(lambda e: model, ccfg, _kb, journal_path=str(journal),
                     verbose=False)
    # lines without the field resume as before: every block replayed
    journal.write_text("".join(json.dumps({k: v for k, v in x.items()
                                           if k != "draw_device"}) + "\n"
                               for x in lines))
    res2 = run_campaign(lambda e: model, ccfg, _kb, journal_path=str(journal),
                        verbose=False)
    for k in ("bit_errors", "frame_errors", "trials", "blocks"):
        assert res1[0][k] == res2[0][k], k
    assert res2[0]["exec_blocks"] == 0
    st = tio.CampaignState(str(journal), draw_device="cuda")
    st.check_resume()


def test_campaign_truthful_iters_and_throughput(tmp_path, split_model):
    ccfg = CampaignConfig(ebno_grid_db=(6.0,), batch=8, min_frame_errors=1,
                          max_trials=16, base_seed=11)
    rec = run_campaign(lambda e: split_model, ccfg, _kb, verbose=False,
                       meta=dict(preset="unit"))[0]
    assert 0 < rec["mean_iters"] < SPLIT.amp_iters, rec["mean_iters"]
    assert rec["preset"] == "unit" and rec["bit_errors_sq"] >= 0
    # pipelined: the 16-trial cap is seen after block 1 is harvested while
    # block 2 is already launched -> 3 blocks, and a steady measurement
    assert rec["blocks"] == 3 and rec["bits_per_s"] is not None
    assert rec["trials"] == 24 and rec["exec_blocks"] == 3

    # one synchronous block: its only timing carries the first use -> None
    ccfg1 = ccfg.replace(max_trials=8)
    rec1 = run_campaign(lambda e: split_model, ccfg1, _kb, verbose=False,
                        pipelined=False)[0]
    assert rec1["blocks"] == 1 and rec1["bits_per_s"] is None
    rec1p = run_campaign(lambda e: split_model, ccfg1, _kb,
                         verbose=False)[0]
    assert rec1p["blocks"] == 2 and rec1p["trials"] == 16

    # a fully journal-replayed point: the same counters, no throughput
    journal = str(tmp_path / "j.jsonl")
    run_campaign(lambda e: split_model, ccfg, _kb, journal_path=journal,
                 verbose=False)
    rec2 = run_campaign(lambda e: split_model, ccfg, _kb,
                        journal_path=journal, verbose=False)[0]
    assert rec2["exec_blocks"] == 0 and rec2["bits_per_s"] is None
    assert rec2["trials"] == rec["trials"]
    assert rec2["bit_errors"] == rec["bit_errors"]


def test_run_point_respects_budget():
    model = SparcModel.build(XLA, 8.0, "cpu")        # high SNR: no errors
    tot = run_point(model.run_block, 0, batch=8, min_frame_errors=1,
                    max_trials=16, pipelined=False)
    assert tot["trials"] == 16 and tot["blocks"] == 2
    assert tot["frame_errors"] == 0
    tot_p = run_point(model.run_block, 0, batch=8, min_frame_errors=1,
                      max_trials=16)
    assert tot_p["trials"] == 24 and tot_p["blocks"] == 3


def test_blocks_are_functions_of_their_coordinates(split_model):
    """The same (seed, point, block) gives the same counters in any run;
    another point gives other draws."""
    def counters(point, seed=5):
        tot = run_point(split_model.run_block, seed, batch=4,
                        min_frame_errors=10 ** 9, max_trials=8,
                        point_idx=point, pipelined=False)
        return {k: tot[k] for k in ("bit_errors", "trials", "iters_sum")}

    assert counters(0) == counters(0)
    assert counters(0) != counters(1) or counters(0) != counters(0, seed=6)


def test_steady_bits_per_s_excludes_the_first_block():
    tot = dict(exec_blocks=3, first_block_s=10.0, exec_trials=24,
               exec_wall_s=12.0)
    assert steady_bits_per_s(tot, 8, 100) == pytest.approx(16 * 100 / 2.0)
    assert steady_bits_per_s(dict(tot, exec_blocks=1), 8, 100) is None
    assert steady_bits_per_s({}, 8, 100) is None


WAIT_S = 0.2      # a waiting block's time


class _WaitingModel:
    """A model whose run_block waits WAIT_S before it returns its counters,
    as a block does whose launch waits for the device (an exchange between
    processes, any synchronizing op, every CPU run)."""
    device = torch.device("cpu")
    k_bits = 100

    def run_block(self, gen, batch):
        time.sleep(WAIT_S)
        zero = torch.zeros((), dtype=torch.int64)
        return dict(bit_errors=zero, frame_errors=zero, iters_sum=zero,
                    bit_errors_sq=zero.double(),
                    trials=torch.full((), batch, dtype=torch.int32))


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "synchronous"])
@pytest.mark.parametrize("blocks", [2, 3, 5])
def test_steady_bits_per_s_of_blocks_that_wait(blocks, pipelined):
    """Each block is timed by its completion: a block that waits WAIT_S
    gives B k_bits / WAIT_S whatever the block count and the dispatch, and
    the first block's time is one block's.  (Timed from one harvest to the
    next instead, the pipelined dispatch would put two blocks into the
    first interval and almost nothing into the last.)"""
    model = _WaitingModel()
    batch = 8
    # the pipelined dispatch launches one block past the trial cap
    cap = (blocks - 1 if pipelined else blocks) * batch
    ccfg = CampaignConfig(ebno_grid_db=(5.0,), batch=batch,
                          min_frame_errors=1, max_trials=cap, base_seed=3)
    rec = run_campaign(lambda e: model, ccfg, lambda m: m.k_bits,
                       verbose=False, pipelined=pipelined)[0]
    assert rec["exec_blocks"] == rec["blocks"] == blocks
    assert rec["first_block_s"] == pytest.approx(WAIT_S, rel=0.1)
    assert rec["bits_per_s"] == pytest.approx(batch * model.k_bits / WAIT_S,
                                              rel=0.1)


def test_a_journal_resumed_point_adds_no_time(tmp_path):
    """Replayed blocks add their counters and no time: a point resumed
    with three of its five blocks on the journal times the two it
    executes."""
    model = _WaitingModel()
    journal = str(tmp_path / "j.jsonl")

    def point():
        state = tio.CampaignState(journal, 1, "cpu")
        state.check_resume()
        return run_point(model.run_block, 3, batch=8, min_frame_errors=1,
                         max_trials=32, state=state, device="cpu")

    full = point()
    assert full["exec_blocks"] == 5
    with open(journal) as f:
        lines = f.read().splitlines()
    with open(journal, "w") as f:
        f.write("\n".join(lines[:3]) + "\n")
    tot = point()
    assert tot["exec_blocks"] == 2 and tot["blocks"] == 5
    assert tot["trials"] == full["trials"] == 40
    assert tot["first_block_s"] == pytest.approx(WAIT_S, rel=0.1)
    assert tot["exec_wall_s"] == pytest.approx(2 * WAIT_S, rel=0.1)
    assert steady_bits_per_s(tot, 8, model.k_bits) == pytest.approx(
        8 * model.k_bits / WAIT_S, rel=0.1)


def test_a_sharding_policy_raises():
    """run_point takes a policy (tests/test_torch_parallel.py runs it); it
    raises where the block's rows cannot be cut over its processes and
    data shards."""
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    pol = ShardingPolicy(make_mesh(1, ["cpu"] * 4))
    with pytest.raises(ValueError, match="not divisible"):
        run_point(lambda g, b: {}, 0, 6, 1, 8, policy=pol)


def test_sweep_builds_a_model_per_point():
    sweep = SparcSweep(XLA, use_pallas=True, device="cpu")
    a, b = sweep.model_for_point(5.0), sweep.model_for_point(6.0)
    assert a.use_pallas and a.ebno_db == 5.0 and b.sigma2 < a.sigma2


@pytest.mark.parametrize("name", [k for k, v in PRESETS.items()])
def test_config_hash_equals_the_reference(name):
    cfg = PRESETS[name]
    assert tprov.config_hash(cfg) == jprov.config_hash(cfg)
    assert tprov.config_hashes(cfg) == jprov.config_hashes(cfg)


def test_artifact_meta_names_backend_and_device():
    meta = tprov.artifact_meta("plain_small", PRESETS["plain_small"], "cpu")
    ref = jprov.artifact_meta("plain_small", PRESETS["plain_small"])
    for k, v in ref.items():
        assert meta[k] == v, k
    assert meta["backend"] == "torch-cpu" and meta["device"] == "cpu"
    assert meta["torch"] == torch.__version__


def test_journal_matches_the_reference_format(tmp_path):
    path = str(tmp_path / "sub" / "j.jsonl")
    st = tio.CampaignState(path)
    st.record_block(0, 0, dict(trials=8, bit_errors=3))
    st.record_block(1, 2, dict(trials=8, bit_errors=0))
    again = jio.CampaignState(path)
    assert again.done == st.done and again.is_done(1, 2)
    assert tio.CampaignState(path).block_record(0, 0)["bit_errors"] == 3
    tio.append_jsonl(path, dict(kind="point", ber=0.5))
    assert list(tio.read_jsonl(path)) == list(jio.read_jsonl(path))
    assert list(tio.read_jsonl(str(tmp_path / "missing.jsonl"))) == []
    assert json.loads(open(path).read().splitlines()[-1])["ber"] == 0.5


def test_profiling_helpers_time_and_trace(tmp_path):
    """trace writes the profiler's trace and the counters beside it; a span
    under it lands in the trace, and without a profiler annotate is one
    shared no-op."""
    assert not tprof.tracing()
    assert tprof.annotate("stage") is tprof.annotate("other")
    with tprof.trace(str(tmp_path / "prof")):
        assert tprof.tracing()
        with tprof.annotate("stage"):
            torch.ones(16).cumsum(0)
        tprof.count("test.rows", 16)
    assert not tprof.tracing()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "stage" and e.get("cat") == "user_annotation"
               for e in events["traceEvents"])
    summary = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert summary["counters"] == {"test.rows": 16.0}
    assert "mesh.exchange" in summary["groups"]
    tprof.reset()
