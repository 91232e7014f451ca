"""dp_gather_ms: device milliseconds a block of the copies between cards
(the profiler's peer-to-peer memcpy events): on a data mesh, beta and the
counts of each card's codewords gathered onto the home card.  Nothing to
read on one card."""


def read(run):
    tl = run.timeline
    if tl is None or not run.blocks:
        return None
    peer = [e for e in tl.device
            if e["cat"] == "gpu_memcpy" and "PtoP" in e["name"]]
    if not peer:
        return None
    lo, hi = tl.span()
    s = sum(max(0.0, min(e["t1"], hi) - max(e["t0"], lo)) for e in peer)
    return 1e-3 * s / len(run.blocks)
