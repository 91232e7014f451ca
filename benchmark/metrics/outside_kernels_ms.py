"""outside_kernels_ms: device milliseconds a block of kernels and memsets
that are not the port's hand-written kernels (every name a roofline module
lists): the draws, a concatenated code's LLR fold and decisions, the
counters.  Copies are left out (dp_gather_ms reads those).  Summed over the
cards, over the blocks of the traced window."""

CATS = ("kernel", "gpu_memset")


def read(run):
    tl = run.timeline
    if tl is None or not run.blocks:
        return None
    port = {n for mod in run.rooflines.values() for n in mod.NAMES}
    return 1e3 * tl.device_seconds(cats=CATS, exclude=port) / len(run.blocks)
