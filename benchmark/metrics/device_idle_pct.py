"""device_idle_pct: the share of the traced window in which a card runs no
kernel, copy or memset (the union of its device intervals), the mean over
the cards the cell uses; each card's share goes to standard error."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    shares = [100.0 * tl.idle_share(d) for d in run.devices]
    for d, s in zip(run.devices, shares):
        run.log(f"device_idle_pct card {d}: {s!r}")
    return sum(shares) / len(shares)
