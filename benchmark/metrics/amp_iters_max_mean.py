"""amp_iters_max_mean: the AMP iterations of each amp_fused call's slowest
codeword, mean over the window's calls (the program's `amp.iters_max` over
`amp.calls` counters, ops/amp_kernel.py).  Beside amp_iters_mean it says
how many of its launches the whole-trial kernel spends on the batch's
stragglers.  Nothing to read without the counters."""

from benchmark.metrics._program import counters


def read(run):
    c = counters()
    if "amp.iters_max" not in c or not c.get("amp.calls"):
        return None
    return c["amp.iters_max"] / c["amp.calls"]
