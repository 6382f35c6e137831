"""Device ms a CSTS eval forward spends in its decoder (the decoder blocks,
the stem skip's upsample and the classifier conv): the program's
``csts.model.decoder`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.forward_stage_ms(ctx, "csts.model.decoder")
