"""block_ms_p50: the median of the milliseconds between successive block
completions in the window (device clock; the first from the window's
start), over all its blocks."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile(run.block_ms, 50) if run.block_ms else None
