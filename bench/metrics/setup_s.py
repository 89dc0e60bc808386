"""Seconds from the process's start to the window's start: imports, the
card's context, drawing the inputs, fit, prune, int8, the server's start and
its warm-up (and, in a checkout's first run, the kernels' build)."""


def read(rec):
    return float(rec.setup_s)
