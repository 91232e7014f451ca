"""bp_iters_mean: BP iterations an LDPC codeword over the window (the
program's `bp.iters` over `bp.codewords` counters, models/ldpc.py).
Nothing to read without an LDPC code."""

from benchmark.metrics._program import counters


def read(run):
    c = counters()
    if "bp.iters" not in c or not c.get("bp.codewords"):
        return None
    return c["bp.iters"] / c["bp.codewords"]
