"""amp_iters_mean: AMP iterations a codeword over the window, the blocks'
iters_sum over their trials (the first AMP pass of a concatenated code)."""


def read(run):
    trials = sum(b.get("trials", 0) for b in run.blocks)
    its = sum(b.get("iters_sum", 0) for b in run.blocks)
    return its / trials if trials else None
