"""amp_feedback_iters_mean: the pinned feedback pass's AMP iterations a
frame over the window (the program's `concat.feedback_iters` counter,
models/concat.py, over the blocks' trials); the first pass is
amp_iters_mean's.  Nothing to read without a concatenated code."""

from benchmark.metrics._program import counters


def read(run):
    c = counters()
    trials = sum(b.get("trials", 0) for b in run.blocks)
    if "concat.feedback_iters" not in c or not trials:
        return None
    return c["concat.feedback_iters"] / trials
