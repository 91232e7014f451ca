"""The port's tracing (sparc_ldpc_tpu_torch/utils/profiling.py) on the CPU.

Tiny SPARC and concatenated campaigns run through the campaign's own
`run_point`.  Under a CPU torch.profiler they show every span of the
program, each inside the span that calls it; the counters equal the sums
taken from the decoders' own results on the same draws; on a virtual data
mesh of two CPU devices the gathered bytes are the second shard's
decisions (int32 indices), trace and iterations, each block's decisions
taken on the shards count once, and the second shard records one interval
of its input copies a block.  Untraced, the same runs enter no span and
leave the registry empty, and the primitives call nothing: no dispatcher
op, no CUDA event, no synchronize.
"""

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)
from torch.utils._python_dispatch import TorchDispatchMode

import sparc_ldpc_tpu_torch.models.amp as model_amp
from sparc_ldpc_tpu_torch.config import ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu_torch.models.concat import ConcatModel
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.parallel.campaign import run_point
from sparc_ldpc_tpu_torch.parallel.mesh import (EXCHANGE_STATS,
                                                ShardingPolicy, make_mesh)
from sparc_ldpc_tpu_torch.utils import profiling as prof
from sparc_ldpc_tpu_torch.utils.io import CampaignState

# the benchmark's routes at a tiny size: the fused split form (K1's plain
# version here) with the noise drawn from per-codeword keys
SPARC = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=8,
                    amp_kernel="fused_split", transform_precision="bf16",
                    amp_noise_in_kernel=True)
CONCAT = ConcatConfig(
    sparc=SPARC.replace(power_alloc="iterative", amp_iters=16,
                        amp_tol=1e-4),
    ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12, engine="qc",
                    schedule="layered", bp_iters=16),
    f_prot=0.5, feedback_iters=4)
# the fast_l4096 cell's decode at a tiny size: per-codeword early stop
EARLY = SPARC.replace(power_alloc="iterative", amp_iters=16, amp_tol=1e-4)
B, BLOCKS, SEED = 8, 3, 2 ** 31 + 7

# each span and the spans that may call it (the nearest span around it)
CALLERS = {
    "campaign.point": {None},
    "campaign.launch": {"campaign.point"},
    "campaign.wait": {"campaign.point"},
    "campaign.journal": {"campaign.point"},
    "block.draw": {"campaign.launch"},
    "block.counters": {"campaign.launch"},
    "amp.fused": {"campaign.launch", "concat.feedback", "mesh.shard"},
    "concat.fold": {"campaign.launch"},
    "bp.decode": {"campaign.launch"},
    "concat.feedback": {"campaign.launch"},
    "mesh.shard": {"campaign.launch"},
    "mesh.gather": {"campaign.launch", "concat.feedback", "block.counters"},
}


@pytest.fixture(autouse=True)
def fresh_registry():
    prof.reset()
    yield
    prof.reset()


@pytest.fixture(scope="module")
def models():
    pol = ShardingPolicy(make_mesh(1, ["cpu", "cpu"]))
    return {"sparc": SparcModel.build(SPARC, 6.0, "cpu"),
            "concat": ConcatModel.build(CONCAT, 4.0, "cpu"),
            "mesh": SparcModel.build(SPARC, 6.0, None, policy=pol),
            "early": SparcModel.build(EARLY, 6.0, "cpu")}


def campaign(model, tmp_path):
    """One campaign point of BLOCKS blocks (and the one over-dispatched),
    journaled: its totals."""
    policy = getattr(model, "policy", None) or getattr(
        getattr(model, "sparc", None), "policy", None)
    state = CampaignState(str(tmp_path / "journal.jsonl"), 1, "cpu")
    return run_point(model.run_block, SEED, B, min_frame_errors=1 << 40,
                     max_trials=BLOCKS * B, state=state, policy=policy)


def traced(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        out = fn()
    return out, p.events()


def caller(ev):
    """The nearest span of CALLERS around the event, or None."""
    up = ev.cpu_parent
    while up is not None and up.name not in CALLERS:
        up = up.cpu_parent
    return None if up is None else up.name


def spans(events):
    return [e for e in events if e.name in CALLERS]


def spy(obj, name, log):
    """obj.name records (kwargs, result) of each call into log."""
    orig = getattr(obj, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        log.append((a, kw, out))
        return out

    object.__setattr__(obj, name, wrapped)


def count_names(events):
    out = {}
    for e in spans(events):
        out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.parametrize("kind", ["sparc", "concat", "mesh"])
def test_spans_nest_as_the_program_calls(models, tmp_path, kind):
    tot, events = traced(lambda: campaign(models[kind], tmp_path))
    blocks = int(tot["blocks"])
    assert blocks == BLOCKS + 1 == tot["exec_blocks"]
    for e in spans(events):
        assert caller(e) in CALLERS[e.name], (e.name, caller(e))
    n = count_names(events)
    expect = {"campaign.point": 1, "campaign.launch": blocks,
              "campaign.wait": blocks, "campaign.journal": blocks,
              "block.draw": blocks, "block.counters": 2 * blocks}
    if kind == "concat":
        expect.update({"amp.fused": 2 * blocks, "concat.fold": blocks,
                       "bp.decode": blocks, "concat.feedback": blocks,
                       "block.counters": blocks})
    elif kind == "mesh":
        # two shards a block, three gathers (indices, trace, iterations)
        expect.update({"amp.fused": 2 * blocks, "mesh.shard": 2 * blocks,
                       "mesh.gather": 3 * blocks})
    else:
        expect["amp.fused"] = blocks
    assert n == expect


def test_concat_counters_equal_the_decoders_results(models, tmp_path):
    """concat.feedback_iters, bp.iters and bp.codewords against the sums of
    the pinned pass's and BP's own results in the same traced run."""
    m = models["concat"]
    fb, bp = [], []
    spy(m.sparc, "decode", fb)
    spy(m.ldpc, "decode", bp)
    try:
        tot, _ = traced(lambda: campaign(m, tmp_path))
    finally:
        object.__delattr__(m.sparc, "decode")
        object.__delattr__(m.ldpc, "decode")
    feedback = [out.iters for _, kw, out in fb
                if kw.get("T") == CONCAT.feedback_iters]
    assert len(feedback) == len(bp) == tot["blocks"]
    c = prof.counters()
    assert set(c) == {"concat.feedback_iters", "bp.iters", "bp.codewords",
                      "amp.iters_max", "amp.calls"}
    assert c["amp.calls"] == 2 * tot["blocks"]     # both passes a block
    assert c["concat.feedback_iters"] == sum(int(i.sum()) for i in feedback)
    assert c["bp.iters"] == sum(int(out.iters.sum()) for _, _, out in bp)
    assert c["bp.codewords"] == sum(a[0].shape[0] for a, _, _ in bp) == (
        tot["blocks"] * B * m.num_cw)
    assert 0 < c["concat.feedback_iters"] <= (
        tot["trials"] * CONCAT.feedback_iters)
    assert prof.intervals_ms("mesh.shard_inputs") == []


def test_mesh_counts_the_second_shards_gather_and_input_wait(models,
                                                            tmp_path):
    m = models["mesh"]
    tot, _ = traced(lambda: campaign(m, tmp_path))
    blocks, half, T = int(tot["blocks"]), B // 2, m.cfg.amp_iters
    shard = half * SPARC.L * 4 + T * half * 4 + half * 4
    c = prof.counters()
    assert c.pop("amp.calls") == 2 * blocks       # one call a shard
    assert 0 < c.pop("amp.iters_max") <= 2 * blocks * T
    assert c == {"mesh.gather_bytes": blocks * shard,
                 "mesh.local_decisions": blocks}
    ivs = prof.intervals_ms("mesh.shard_inputs")
    assert len(ivs) == blocks
    assert all(ms >= 0 and dev is None for ms, dev in ivs)
    s = prof.summary()
    assert s["intervals"]["mesh.shard_inputs"]["count"] == blocks


def amp_results(monkeypatch):
    """Every amp_fused call's (beta, trace, iters), as the decoder gets
    them."""
    log, orig = [], model_amp.amp_fused

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(model_amp, "amp_fused", wrapped)
    return log


@pytest.mark.parametrize("kind", ["early", "concat"])
def test_amp_counters_are_each_calls_slowest_codeword(models, tmp_path,
                                                      monkeypatch, kind):
    """amp.iters_max is the sum of each amp_fused call's largest
    per-codeword iteration count, amp.calls the calls (concat: both
    passes), on early-stopping blocks of the CPU route."""
    log = amp_results(monkeypatch)
    tot, _ = traced(lambda: campaign(models[kind], tmp_path))
    per_block = 2 if kind == "concat" else 1
    assert len(log) == per_block * tot["blocks"]
    c = prof.counters()
    assert c["amp.calls"] == len(log)
    assert c["amp.iters_max"] == sum(int(it.max()) for _, _, it in log)
    if kind == "early":
        its = torch.cat([it for _, _, it in log])
        # the codewords stop at different iterations, before the cap
        assert int(its.min()) < int(its.max()) < EARLY.amp_iters
        assert tot["iters_sum"] == int(its.sum())
        assert c["amp.iters_max"] > tot["iters_sum"] / B


def test_untraced_amp_counts_keep_no_tensor(models, tmp_path):
    """Untraced, an early-stopping campaign records nothing and keeps no
    tensor, and the decode takes no maximum of the iterations."""
    with Ops() as ops:
        campaign(models["early"], tmp_path)
    assert prof._REG.counts == {}
    assert not [o for o in ops.ops if o.startswith("aten.max")]
    # traced (a journal of its own), the same campaign takes them
    (tmp_path / "traced").mkdir()
    _, events = traced(lambda: campaign(models["early"],
                                        tmp_path / "traced"))
    assert [e for e in events if e.name == "aten::max"]


class Ops(TorchDispatchMode):
    """Every dispatcher op called under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["sparc", "concat", "mesh"])
def test_untraced_runs_enter_no_span_and_count_nothing(models, tmp_path,
                                                       kind):
    with Ops() as ops:
        campaign(models[kind], tmp_path)
    assert not [o for o in ops.ops if o.startswith("profiler.")]
    assert prof.counters() == {}
    assert prof.intervals_ms("mesh.shard_inputs") == []


def test_primitives_call_nothing_untraced(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while untraced")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    x = torch.arange(4)
    assert not prof.tracing()
    with Ops() as ops:
        with prof.annotate("a") as a, prof.annotate("b") as b:
            prof.count("c", x)
            prof.count("c", 3)
            with prof.interval("i", "cuda:0"):
                pass
    assert ops.ops == [] and a is None and b is None
    assert prof.annotate("a") is prof.annotate("b") is prof.interval(
        "i", "cuda:0")
    assert prof.counters() == {} and prof.intervals_ms("i") == []


def test_traced_primitives_and_the_readers():
    x = torch.arange(4, dtype=torch.int32)
    _, events = traced(lambda: [prof.count("c", x), prof.count("c", 3),
                                prof.count("c", torch.tensor(True)),
                                prof.interval("i", "cpu").__enter__()
                                .__exit__(None, None, None)])
    assert prof.counters() == {"c": 10.0}
    (ms, dev), = prof.intervals_ms("i")
    assert ms >= 0 and dev is None
    # counted only while tracing: nothing after the profiler stops
    prof.count("c", 100)
    assert prof.counters() == {"c": 10.0}
    prof.reset()
    assert prof.counters() == {} and prof.intervals_ms("i") == []


def test_exchange_stats_are_a_group_of_the_registry():
    """The section exchange's counts stay the CLI's keys, count untraced,
    and reset in place."""
    assert prof.group("mesh.exchange") is EXCHANGE_STATS
    assert set(EXCHANGE_STATS) == {"calls", "bytes", "s"}
    EXCHANGE_STATS["calls"] += 2
    EXCHANGE_STATS["s"] += 0.5
    assert prof.groups()["mesh.exchange"] == {"calls": 2, "bytes": 0,
                                              "s": 0.5}
    prof.reset()
    assert EXCHANGE_STATS == {"calls": 0, "bytes": 0, "s": 0.0}
    assert isinstance(EXCHANGE_STATS["s"], float)
