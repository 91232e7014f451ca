"""setup_s: seconds from the process's start to the window's first launch:
imports, the code's design, the library loads (and their build in a fresh
checkout) and the warm-up campaign call."""


def read(run):
    return run.setup_s
