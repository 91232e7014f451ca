"""launch_ms: the mean host milliseconds of the window's `campaign.launch`
spans, the program's span around `run_block` and the staging of its
counters (parallel/campaign.py): how long the host takes to queue a block.
Where it approaches the block's time, the host holds the cards back.
Nothing to read where the program records no such span."""

SPAN = "campaign.launch"


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    lo, hi = tl.span()
    ms = [1e-3 * (e["t1"] - e["t0"]) for e in tl.host
          if e["name"] == SPAN and lo <= e["t0"] <= hi]
    return sum(ms) / len(ms) if ms else None
