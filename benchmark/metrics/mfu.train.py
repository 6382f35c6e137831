"""The training step's share of the card's peak: a clip's forward and
backward FLOPs (``counts``, no recomputation) times the clips of the
window's steps outside the traced stretch, over their seconds (host clock),
over 989 TFLOP/s (bf16 dense), in %."""

from benchmark.counts import PEAK_FLOPS


def read(ctx):
    if not (ctx.get("trace") and ctx.get("train")):
        return None
    return 100.0 * ctx["flops_per_clip"] * ctx["untraced_clips"] / ctx["untraced_s"] / PEAK_FLOPS
