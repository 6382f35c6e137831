"""Device ms a training step spends in its backward (the backward passes and
the model axes' gradient sync): the program's ``csts.train_step.backward``
spans, summed a step (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.step_phase_ms(ctx, "csts.train_step.backward")
