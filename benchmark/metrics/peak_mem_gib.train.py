"""The card's allocated peak over the training window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start), in GiB."""


def read(ctx):
    return ctx["window_peak_bytes"] / 2 ** 30 if ctx.get("train") else None
