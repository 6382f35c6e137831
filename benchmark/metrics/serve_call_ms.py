"""The mean host ms of one ``GazePredictor.predict`` call in the window, timed
by the benchmark's proxy between the batcher and the predictor."""


def read(ctx):
    if not (ctx.get("serve") and ctx["predict_calls"]):
        return None
    return 1e3 * ctx["predict_s"] / ctx["predict_calls"]
