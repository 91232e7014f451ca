"""dp_shard_wait_ms: the mean device milliseconds of the window's
`mesh.shard_inputs` intervals.  On a data mesh the program records one a
block on each data shard but the home one (parallel/amp_sharded.py
`_data_parallel`): two timing events on that shard's card around its
copies of the tables from the home card.  A copy between two cards runs
on the source card's stream behind the work queued there, so the interval
is the time the shard's card waits for the home card's K1.  Nothing to
read on one card."""

from benchmark.metrics._program import intervals_ms


def read(run):
    ms = intervals_ms("mesh.shard_inputs")
    return sum(ms) / len(ms) if ms else None
