"""dp_gather_gb: the bytes a block that the data shards other than the
home one send to the home card in the gather (beta, the tau2 trace and the
iterations; the program's `mesh.gather_bytes` counter, parallel/mesh.py),
in 1e9 bytes.  Nothing to read on one card."""

from benchmark.metrics._program import counters


def read(run):
    c = counters()
    if "mesh.gather_bytes" not in c or not run.blocks:
        return None
    return c["mesh.gather_bytes"] / len(run.blocks) / 1e9
