"""Device ms a training step spends in its forward (the model's training
forward, the frame softmax, kldiv and EgoNCE): the program's
``csts.train_step.forward`` spans, summed a step (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.step_phase_ms(ctx, "csts.train_step.forward")
