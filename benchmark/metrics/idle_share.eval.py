"""The share of the traced window in which no operation ran on the card
(the eval cells), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if not (tr and ctx.get("eval")):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
