"""Clips scored per second: every clip of the offline eval's window over the
window's whole time, which ends in a synchronise (host clock)."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx["clips"], ctx["window_s"]) if ctx.get("eval") else None
