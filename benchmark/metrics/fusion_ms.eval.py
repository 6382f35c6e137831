"""Device ms a CSTS eval forward spends in its audio-visual fusion (the audio
and vision pools, the spatial and temporal fusion blocks and the
reweighting): the program's ``csts.model.fusion`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.forward_stage_ms(ctx, "csts.model.fusion")
