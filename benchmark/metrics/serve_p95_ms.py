"""The 95th percentile of the open loop's request latency, over every
request due in the window, each from when it was due to when its future
resolved; a request that failed or never answered counts as infinitely late
(host clock)."""

from benchmark.stats import percentile


def read(ctx):
    return percentile(ctx["latencies_ms"], 95) if ctx.get("serve") else None
