"""Online serving: a micro-batching dispatcher and a minimal HTTP front
(``csts_tpu/serving_server.py``), over the port's
:class:`~csts_torch.serving.GazePredictor`. The standard library and numpy
only.

* :class:`MicroBatcher`: a thread-safe request queue in front of a
  predictor. Single-clip requests are coalesced into the largest batch that
  is ready within ``max_wait_ms``, and one dispatcher thread runs one
  predictor call per group, so the card sees the predictor's static
  buckets (and their CUDA graphs) while callers see per-request futures.
* :class:`GazeHTTPServer`: a ``ThreadingHTTPServer`` speaking
  npz-over-HTTP. ``POST /predict`` with an ``.npz`` body ``{video, audio}``
  (video either normalized float32 (T, crop, crop, 3) or raw uint8 camera
  frames (T, H, W, 3), which are center-cropped and normalized with the
  predictor's constants) returns an ``.npz`` ``{heatmaps, gaze_xy}``;
  ``GET /healthz`` answers ``ok``; ``GET /stats`` gives the service's
  counters as JSON (requests, batches, clips, errors, mean batch occupancy,
  latency p50/p99).

Any predictor with ``predict(video, audio) -> dict``, ``preprocess_frames``
and ``batch_sizes`` serves: a live predictor or one from ``from_exported``.

    server = GazeHTTPServer(predictor, port=8000).start()
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

_SENTINEL = object()


class MicroBatcher:
    """Coalesce concurrent single-clip requests into device-sized batches.

    ``submit`` returns a future at once; the dispatcher thread pops the
    queue, waits up to ``max_wait_ms`` for more requests, stacks them and
    runs one predictor call for the group (the predictor pads a partial
    bucket). Under load the wait never triggers: the queue refills while the
    device computes, so consecutive batches are full. A group whose call
    raises fails each of its futures with that exception.
    """

    def __init__(self, predictor, max_wait_ms: float = 5.0, max_queue: int = 1024):
        self._pred = predictor
        self._max_batch = max(predictor.batch_sizes)
        self._max_wait = max_wait_ms / 1e3
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._stats = {"requests": 0, "batches": 0, "clips": 0, "errors": 0}
        self._latencies: collections.deque = collections.deque(maxlen=2048)
        # The clip contract: fixed from the config where the predictor has
        # one, so that a malformed first request cannot lock in its shapes;
        # an exported predictor (cfg None) takes the first request's.
        self._shapes = None
        cfg = getattr(predictor, "cfg", None)
        if cfg is not None:
            t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
            self._shapes = ((t, s, s, 3), (t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1))
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="gaze-microbatcher", daemon=True)
        self._thread.start()

    def submit(self, video: np.ndarray, audio: np.ndarray) -> Future:
        """Enqueue one clip: ``video`` (T, crop, crop, 3) float32 normalized,
        ``audio`` (T, F, S, 1) float32. Resolves to {heatmaps (T, h, w),
        gaze_xy (T, 2)}. Raises ``RuntimeError`` after :meth:`close`."""
        fut: Future = Future()
        video = np.asarray(video, np.float32)
        audio = np.asarray(audio, np.float32)
        if video.ndim != 4 or audio.ndim != 4:
            fut.set_exception(ValueError(
                f"expected one clip: video (T,H,W,3) and audio (T,F,S,1), "
                f"got {video.shape} / {audio.shape}"))
            return fut
        # the closed check and the enqueue share the lock with close(), so an
        # accepted request is queued before close() drains
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._shapes is None:
                self._shapes = (video.shape, audio.shape)
            elif (video.shape, audio.shape) != self._shapes:
                fut.set_exception(ValueError(
                    f"shape mismatch: this service batches {self._shapes}, "
                    f"got {(video.shape, audio.shape)}"))
                return fut
            try:
                self._queue.put_nowait((video, audio, fut, time.monotonic()))
                self._stats["requests"] += 1
            except queue.Full:
                self._stats["errors"] += 1
                fut.set_exception(RuntimeError("request queue full"))
        return fut

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._stats)
            lat = sorted(self._latencies)
        out["mean_batch_occupancy"] = out["clips"] / out["batches"] if out["batches"] else 0.0
        if lat:
            out["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            out["latency_p99_ms"] = 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher once the group it holds is served, waiting at
        most ``timeout`` seconds for it. Every request it never ran fails
        with ``RuntimeError``. Never blocks on a full queue: the dispatcher
        sees the stop flag before it takes another request."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        try:  # wakes a dispatcher blocked on an empty queue
            self._queue.put_nowait(_SENTINEL)
        except queue.Full:  # then it is not blocked: it holds work and will see the flag
            pass
        self._thread.join(timeout=timeout)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                self._fail([item], RuntimeError("MicroBatcher closed"))

    def _fail(self, items, exc: BaseException) -> None:
        with self._lock:
            self._stats["errors"] += len(items)
        for _, _, fut, _ in items:
            if not fut.done():
                fut.set_exception(exc)

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is _SENTINEL:
                return
            if self._stop.is_set():
                self._fail([item], RuntimeError("MicroBatcher closed"))
                return
            items = [item]
            deadline = time.monotonic() + self._max_wait
            while len(items) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    break  # serve what is held; the loop then sees the flag
                items.append(nxt)
            self._dispatch(items)

    def _dispatch(self, items) -> None:
        video = np.stack([it[0] for it in items])
        audio = np.stack([it[1] for it in items])
        try:
            out = self._pred.predict(video, audio)
        except Exception as exc:  # noqa: BLE001 — fail the whole group
            self._fail(items, exc)
            return
        done = time.monotonic()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["clips"] += len(items)
            for _, _, _, t0 in items:
                self._latencies.append(done - t0)
        for i, (_, _, fut, _) in enumerate(items):
            fut.set_result({"heatmaps": out["heatmaps"][i], "gaze_xy": out["gaze_xy"][i]})


class _GazeHandler(BaseHTTPRequestHandler):
    # the server instance carries .batcher and .request_timeout (GazeHTTPServer)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _respond(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._respond(200, b"ok", "text/plain")
        elif self.path == "/stats":
            self._respond(200, json.dumps(self.server.batcher.stats()).encode(),
                          "application/json")
        else:
            self._respond(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._respond(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            blob = np.load(io.BytesIO(self.rfile.read(length)))
            video, audio = blob["video"], blob["audio"]
            if video.dtype == np.uint8:
                # raw camera frames (T, H, W, 3): center crop and normalize
                # with the predictor's own constants
                video = self.server.batcher._pred.preprocess_frames(video)
        except Exception as exc:  # noqa: BLE001 — a malformed request body
            self._respond(400, str(exc).encode() or b"bad request", "text/plain")
            return
        try:
            result = self.server.batcher.submit(video, audio).result(
                timeout=self.server.request_timeout)
        except ValueError as exc:  # the clip contract: the client's fault
            self._respond(400, str(exc).encode(), "text/plain")
            return
        except FuturesTimeoutError:
            self._respond(504, f"prediction did not complete within "
                               f"{self.server.request_timeout}s".encode(), "text/plain")
            return
        except Exception as exc:  # noqa: BLE001 — a failure on the server's side
            self._respond(500, str(exc).encode() or type(exc).__name__.encode(), "text/plain")
            return
        buf = io.BytesIO()
        np.savez(buf, **result)
        self._respond(200, buf.getvalue(), "application/octet-stream")


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connects of more
    # concurrent clients than that while the accept loop waits for the GIL,
    # and a dropped connect is retried after the kernel's 1 s SYN timeout
    request_queue_size = 128
    daemon_threads = True


class GazeHTTPServer:
    """npz-over-HTTP gaze inference (the standard library's server, a thread
    a request, so that concurrent POSTs coalesce in the
    :class:`MicroBatcher`)."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 5.0, request_timeout: float = 60.0):
        self.batcher = MicroBatcher(predictor, max_wait_ms=max_wait_ms)
        self._httpd = _Server((host, port), _GazeHandler)
        self._httpd.batcher = self.batcher
        self._httpd.request_timeout = request_timeout
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "GazeHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="gaze-http",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.batcher.close()
