"""Seconds from the process's start to the measured window: imports, the
card, the kernels' build (on a checkout's first run), weights and inputs
made from the seed, and the warm-up of every shape the cell uses (host clock)."""


def read(ctx):
    return ctx["setup_s"]
