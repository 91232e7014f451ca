"""k2_roofline: K2's share of its roofline, the least time of the window's
BP calls by their frozen count (benchmark/rooflines/k2.py) over K2's device
time in the trace, in percent."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "k2")
