"""Serving: an open loop of one-clip requests into the port's in-process
service, ``csts_torch.serving_server.MicroBatcher`` in front of
``csts_torch.serving.GazePredictor`` (buckets ``traffic.buckets``, CUDA
graphs, the batcher's ``traffic.max_wait_ms`` wait), as clips arrive from
many independent wearers.

Requests arrive at ``traffic.rate_per_s`` on the open loop of
``traffic.open_loop`` (the same gaps for every seed, in the seed's order),
each a normalised float32 clip on the host drawn from a seeded pool of
``traffic.pool`` clips. Each request is timed from when it was due to when
its future resolved; the generator's lateness is kept beside it. Requests
stop at ``--seconds``; the window ends when every one has answered, or a
minute later; one that failed or never answered counts as infinitely late.
The benchmark's proxy around the predictor times each ``predict`` call.

The check: a sample of ``traffic.check_requests`` of the requests, drawn
from the seed, is kept; once the window has closed and the service is shut,
the fp32 reference runs over their clips: the worst frame's total variation
distance between the heatmaps each request got and the reference's, and
the count of requests that never answered (limit 0).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, traffic, weights
from benchmark.drivers.offline import reference_outputs
from benchmark.reference import arch as ref_arch
from benchmark.reference import lowp, models
from benchmark.trace import Traced

WAIT_AFTER_S = 60.0


class TimedPredictor:
    """The predictor as the batcher sees it, with each ``predict`` call timed."""

    def __init__(self, pred):
        self.pred = pred
        self.batch_sizes = pred.batch_sizes
        self.cfg = pred.cfg
        self.calls, self.seconds = 0, 0.0

    def predict(self, video, audio):
        t = time.perf_counter()
        try:
            return self.pred.predict(video, audio)
        finally:
            self.seconds += time.perf_counter() - t
            self.calls += 1


def setup(run) -> Dict:
    from csts_torch.serving import GazePredictor
    from csts_torch.serving_server import MicroBatcher

    keys, tr, dev = run.keys, run.cell["traffic"], run.device
    cfg = program.program_cfg(keys)
    a = ref_arch.csts_arch(keys)
    w = weights.make(run.seed, models.csts_params(a), dev, program.compute_dtype(keys))
    with dev:
        pred = GazePredictor(cfg, w, batch_sizes=tr["buckets"], device=dev)
    del w
    run.mark("predictor")
    gen = traffic.generator(run.seed, "inputs", dev)
    video, audio = [], []
    for i in range(0, tr["pool"], 8):
        c = traffic.clips(min(8, tr["pool"] - i), a.frames, a.crop, a.freq_bins, a.window, gen,
                          torch.float32)
        video.append(c["video"].cpu().numpy())
        audio.append(c["audio"].cpu().numpy())
    video, audio = np.concatenate(video), np.concatenate(audio)
    run.mark("inputs")
    for b in tr["buckets"]:  # eager, then the graph's capture, then a replay
        for _ in range(3):
            pred.predict(video[:b], audio[:b])
    proxy = TimedPredictor(pred)
    batcher = MicroBatcher(proxy, max_wait_ms=tr["max_wait_ms"])
    for f in [batcher.submit(video[i % len(video)], audio[i % len(video)])
              for i in range(max(tr["buckets"]))]:
        f.result(timeout=WAIT_AFTER_S)
    program.sync(dev)
    return {"pred": pred, "proxy": proxy, "batcher": batcher, "video": video, "audio": audio}


def _close_trace(tracing) -> Dict:
    tracing.__exit__(None, None, None)
    out = tracing.summary()
    out["idle_gaps"] = tracing.idle_gaps()
    return out


def window(run, st) -> Dict:
    tr, dev = run.cell["traffic"], run.device
    batcher, proxy, video, audio = st["batcher"], st["proxy"], st["video"], st["audio"]
    due = traffic.open_loop(tr["rate_per_s"], run.seconds, run.seed)
    order = traffic.clip_order(len(due), len(video), run.seed)
    keep = set(traffic.sample(len(due), tr["check_requests"], run.seed))
    n = len(due)
    done_at = [math.inf] * n
    kept: Dict[int, np.ndarray] = {}
    answered = threading.Event()
    lock = threading.Lock()
    remaining = [n]

    def on_done(j, fut):
        t = time.perf_counter()
        ok = fut.exception() is None
        with lock:
            if ok:
                done_at[j] = t
                if j in keep:
                    kept[j] = fut.result()["heatmaps"]
            remaining[0] -= 1
            if remaining[0] == 0:
                answered.set()

    before = batcher.stats()
    proxy.calls, proxy.seconds = 0, 0.0
    late, tracing, summary = [], None, None
    t_trace = (run.seconds - tr["trace_s"]) / 2
    t0 = time.perf_counter()
    for j in range(n):
        # the traced stretch traces the host too: the card's activities alone
        # leave out the kernels the dispatcher thread's graphs replay
        if run.trace and summary is None:
            if tracing is None and due[j] >= t_trace:
                tracing = Traced(work=False, host=True).__enter__()
            elif tracing is not None and due[j] >= t_trace + tr["trace_s"]:
                summary = _close_trace(tracing)
        wait = t0 + due[j] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(max(0.0, -wait))
        fut = batcher.submit(video[order[j]], audio[order[j]])
        fut.add_done_callback(lambda f, j=j: on_done(j, f))
    if tracing is not None and summary is None:  # the window ended inside the stretch
        summary = _close_trace(tracing)
    answered.wait(timeout=max(0.0, t0 + run.seconds + WAIT_AFTER_S - time.perf_counter()))
    elapsed = time.perf_counter() - t0
    after = batcher.stats()
    lat = [(done_at[j] - (t0 + due[j])) * 1e3 for j in range(n)]
    failed = sum(1 for x in lat if math.isinf(x))
    batches = after["batches"] - before["batches"]
    st.update(order=order, kept=kept, unanswered=failed)
    ctx = {"latencies_ms": lat, "attempted": n, "failed": failed, "window_s": elapsed,
           "late_ms": [x * 1e3 for x in late], "memory_peak_bytes": program.peak_bytes(dev),
           "serve_clips": after["clips"] - before["clips"], "serve_batches": batches,
           "predict_calls": proxy.calls, "predict_s": proxy.seconds, "serve": True}
    if summary is not None:
        ctx["trace"] = summary
    return ctx


def check(run, st, ctx, controls=()) -> List[Dict]:
    keep = sorted(st["kept"])
    clips = sorted({int(st["order"][j]) for j in keep})
    video = torch.from_numpy(st["video"][clips]).to(run.device)
    audio = torch.from_numpy(st["audio"][clips]).to(run.device)
    served = torch.from_numpy(np.stack([st["kept"][j] for j in keep])).to(run.device)
    row = [clips.index(int(st["order"][j])) for j in keep]
    unanswered = st["unanswered"]
    close(st)
    program.free(run.device)
    program.reference_mode()
    ref = reference_outputs(run, video, audio)[..., 0][row]
    out = [{"name": "heatmap_tv", "value": program.heatmap_gap(served, ref) if keep else None},
           {"name": "unanswered", "value": float(unanswered)}]
    if "fp8" in controls:
        low = reference_outputs(run, video, audio, lowp.fp8)[..., 0][row]
        out.append({"name": "heatmap_tv.fp8", "value": program.heatmap_gap(low, ref)})
    return out


def close(st) -> None:
    """Shut the service (the harness calls it also when a run fails)."""
    if "batcher" in st:
        st["batcher"].close()
    st.clear()
