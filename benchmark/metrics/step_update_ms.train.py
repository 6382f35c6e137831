"""Device ms a training step spends in its update (the global norm, the clip,
AdamW, the EMA and the stats' reduction): the program's
``csts.train_step.update`` spans, summed a step (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.step_phase_ms(ctx, "csts.train_step.update")
