"""setup_s: the seconds from the start of the process to the window's
start: imports, the kernels built (first run in a checkout) or loaded, the
inputs made from the seed, the cell's shapes warmed."""


def read(rec, log):
    return rec["setup_s"]
