"""Clips a batch of the service in the window: ``MicroBatcher.stats()``'s
clips over its batches (their change over the window)."""


def read(ctx):
    if not (ctx.get("serve") and ctx["serve_batches"]):
        return None
    return ctx["serve_clips"] / ctx["serve_batches"]
