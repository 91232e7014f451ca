"""k1_roofline: K1's share of its roofline, the least time of the window's
K1 calls by their frozen count (benchmark/rooflines/k1.py) over K1's device
time in the trace, in percent."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "k1")
