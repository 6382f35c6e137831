"""Device ms a training step spends outside the port's kernel families
(cuDNN, cuBLAS and PyTorch's own kernels: convolutions, products,
elementwise, copies), from the traced steps."""

from benchmark.trace import PORT_FAMILIES


def read(ctx):
    tr = ctx.get("trace")
    if not (tr and ctx.get("train")):
        return None
    plain = sum(s for f, s in tr["families_s"].items() if f not in PORT_FAMILIES)
    return 1e3 * plain / ctx["traced_steps"]
