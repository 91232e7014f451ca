"""decoded_bits_per_s: the message bits of every trial of every block that
completed in the window, over the window's time (host clock, from the first
launch to the last block's completion, ended by a synchronize).  Blocks that
decode wrongly count: their errors are the statistics a campaign
measures."""


def read(run):
    trials = sum(b.get("trials", 0) for b in run.blocks)
    if not trials:
        return None
    return trials * run.message_bits / run.window_s
