"""block_ms_p90: the 90th percentile of the milliseconds between successive
block completions, read only where at least ten blocks lie beyond it."""

from benchmark.harness.stats import tail_percentile


def read(run):
    return tail_percentile(run.block_ms, 90, beyond=10)
