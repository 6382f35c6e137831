"""Device ms an eval forward spends in its encoders (the patch and position
embeddings and every encoder block; both branches in CSTS, the classifier's
blocks without its head): the program's ``csts.model.encoders`` spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.forward_stage_ms(ctx, "csts.model.encoders")
