"""The port's kernels against their roofline in the traced eval calls: the
sum over their launches of each launch's least time (the larger of its
operations over 989 TFLOP/s and its bytes over 3.35 TB/s, from its shapes)
over the device time of the port's kernel families, in %."""

from benchmark.trace import PORT_FAMILIES


def read(ctx):
    tr = ctx.get("trace")
    if not (tr and ctx.get("eval")):
        return None
    least = sum(w[3] for w in tr["kernel_work"].values())
    spent = sum(s for f, s in tr["families_s"].items() if f in PORT_FAMILIES)
    return 100.0 * least / spent if least > 0 and spent > 0 else None
