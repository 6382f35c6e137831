"""Clips trained per second: every clip of every step of the window over the
window's whole time, which ends in a synchronise (host clock)."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx["clips"], ctx["window_s"]) if ctx.get("train") else None
