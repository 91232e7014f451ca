"""A kernel's share of its roofline over a traced window."""


def share(run, kernel: str):
    """100 x (sum of the least times of the kernel's calls) / (its device
    time), None when the trace holds none of its launches."""
    tl = run.timeline
    roof = run.rooflines[kernel]
    recs = run.calls.get(kernel, [])
    if tl is None or not recs:
        return None
    busy = tl.device_seconds(cats=("kernel",), names=roof.NAMES)
    if busy <= 0:
        return None
    return 100.0 * sum(roof.least(r) for r in recs) / busy
