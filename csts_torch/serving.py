"""Inference API: load once, predict gaze heatmaps at fixed batch buckets
(``csts_tpu/serving.py``).

    predictor = GazePredictor.from_checkpoint(cfg, "weights.npz")  # or .pyth
    out = predictor.predict(video, audio)   # dict of numpy arrays

The forward is the model at eval followed by the per-frame softmax at T=2.
It runs on CUDA unless ``device`` names another device; with no CUDA and no
device given it raises.

A request goes to the smallest bucket that holds it. Each bucket has static
device buffers for video and audio: the request's n clips are copied in
(on CUDA through pinned staging buffers) and rows n..bucket-1 are filled
with the last clip on the device. On CUDA a
bucket's first request runs eagerly, its second captures the forward in a
CUDA graph (``torch.cuda.CUDAGraph``) over those buffers, and every later
request replays it. A graph is keyed by the values of the experiment
switches (``csts_torch.tools.ab_flags.flag_registry``): a switch flipped
after a capture starts the bucket over, so a stale graph is never
replayed. A request larger than the largest bucket runs one eager forward
at its own size. :meth:`GazePredictor.forward` stays eager.

For deployment, :meth:`GazePredictor.export_compiled` writes one
``torch.export`` program per bucket, with the kernels kept whole as the
custom ops of ``csts_torch.kernels``, and the weights once beside them; a
serving host reloads it with :meth:`GazePredictor.from_exported`, which
imports no model or config code.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from csts_torch import resolve_device

ARTIFACT_WEIGHTS = "params.pt"
ARTIFACT_META = "meta.json"


def _program_file(bucket: int) -> str:
    return f"forward_b{bucket}.pt2"


def _switches() -> tuple:
    """The values of the port's experiment switches, which decide a kernel
    route when the forward runs (and so what a graph captured). A switch
    whose module was never imported reads None: nothing flipped it (an
    exported program imports no model code)."""
    from csts_torch.tools.ab_flags import SWITCHES

    return tuple(getattr(sys.modules[mod], attr) if mod in sys.modules else None
                 for mod, attr in SWITCHES.values())


class _Slot:
    """One bucket's static device buffers and, on CUDA, its graph and the
    pinned host buffers its requests are staged in."""

    def __init__(self, video: torch.Tensor, audio: torch.Tensor):
        self.video, self.audio = video, audio
        self.stage: Optional[List[torch.Tensor]] = None
        self.staged: Optional[torch.cuda.Event] = None  # the copies out of ``stage`` ran
        self.key: Optional[tuple] = None  # the switches the bucket warmed up under
        self.warm = False                 # ran eagerly once under ``key``
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None


class GazePredictor:
    """Batched gaze-heatmap inference with shape bucketing."""

    _replicas: Optional[List["GazePredictor"]] = None  # with ``devices=``: one a device

    def __init__(self, cfg, state_dict, batch_sizes: Sequence[int] = (1, 8), device=None,
                 devices: Optional[Sequence] = None):
        """``devices``: a list of devices (JAX's ``mesh=``, the data axis):
        one replica of the weights on each, with its own buffers and CUDA
        graphs at a 1/len(devices) share of every bucket. A bucket's rows
        are split over the replicas in order and the answers concatenated
        on the first device; every bucket must divide by the number of
        devices. ``device`` is then ignored."""
        from csts_torch.models.csts import CSTS, build_spec
        from csts_torch.train.losses import frame_softmax

        if devices is not None:
            k = len(devices)
            bad = [b for b in batch_sizes if b % k]
            if not k or bad:
                raise ValueError(f"batch buckets {bad} do not divide over {k} devices")
            self._replicas = [GazePredictor(cfg, state_dict, [b // k for b in batch_sizes],
                                            device=d) for d in devices]
            first = self._replicas[0]
            self.device, self.cfg, self.spec, self.model = (first.device, cfg, first.spec,
                                                            first.model)
            self._program = first._program
            self._setup(batch_sizes, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.MEAN, cfg.DATA.STD)
            return
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = build_spec(cfg)
        model = CSTS(self.spec)
        model.load_state_dict(state_dict, strict=True)
        if cfg.TRAIN.MIXED_PRECISION:
            model = model.to(torch.bfloat16)
        self.model = model.to(self.device).eval()
        self._program = lambda video, audio: frame_softmax(self.model(video, audio),
                                                           temperature=2.0)
        self._setup(batch_sizes, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.MEAN, cfg.DATA.STD)

    @property
    def devices(self) -> List[torch.device]:
        """The replicas' devices (one: this predictor's own)."""
        return [r.device for r in self._replicas] if self._replicas else [self.device]

    def _setup(self, batch_sizes, crop, mean, std) -> None:
        self.batch_sizes = sorted(int(b) for b in batch_sizes)
        self._crop = int(crop)
        self._mean = [float(m) for m in mean]
        self._std = [float(s) for s in std]
        self._slots: Dict[int, _Slot] = {}
        self._lock = threading.RLock()  # predict holds it through the read-back

    @classmethod
    def from_checkpoint(cls, cfg, checkpoint_path: Optional[str] = None,
                        use_ema: bool = False, **kwargs) -> "GazePredictor":
        """Weights from ``checkpoint_path``:

        * ``.npz``: a TrainState archive of either package (the params, or
          with ``use_ema`` the EMA leaves of an ``SOLVER.EMA_DECAY`` run);
        * any other path: a ``torch.save``d state dict under the port's (the
          reference's) names, or a reference ``.pyth`` (its ``model_state``);
        * None: the port's seeded init (``init_params`` from
          ``cfg.RNG_SEED``), whose values differ from the JAX package's
          ``PRNGKey`` init.

        ``use_ema`` raises unless the config has ``SOLVER.EMA_DECAY > 0`` and
        the archive carries EMA leaves."""
        from csts_torch.models.csts import CSTS, build_spec, init_params
        from csts_torch.utils.checkpoint import load_params_npz, load_state_dict_file

        if use_ema and not (checkpoint_path and checkpoint_path.endswith(".npz")):
            raise ValueError("use_ema needs a TrainState .npz")
        if checkpoint_path and not checkpoint_path.endswith(".npz"):
            return cls(cfg, load_state_dict_file(checkpoint_path), **kwargs)
        model = CSTS(build_spec(cfg))
        if checkpoint_path is None:
            init_params(model, torch.Generator().manual_seed(cfg.RNG_SEED))
        else:
            if use_ema and not cfg.SOLVER.EMA_DECAY > 0:
                raise ValueError("use_ema requires SOLVER.EMA_DECAY > 0 in the config "
                                 "(the TrainState must carry the EMA leaves)")
            if load_params_npz(checkpoint_path, model, use_ema) != use_ema:
                raise ValueError(f"{checkpoint_path} has no EMA leaves")
        return cls(cfg, model.state_dict(), **kwargs)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def preprocess_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) uint8 -> normalized center-cropped (T, crop, crop, 3)."""
        from csts_torch.data import transform

        size = self._crop
        dummy_gaze = np.full((frames_u8.shape[0], 3), 0.5)
        out, _ = transform.spatial_sampling_fused(
            frames_u8, dummy_gaze, spatial_idx=1, min_scale=size, max_scale=size,
            crop_size=size, random_horizontal_flip=False, rng=None,
            mean=self._mean, std=self._std,
        )
        return out

    # ------------------------------------------------------------------
    # the forward: eager, and through a bucket's buffers and graph
    # ------------------------------------------------------------------

    def forward(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Device tensors in, per-frame heatmap probabilities (B, T, h, w, 1)
        out; eager, at the inputs' own batch size."""
        with torch.inference_mode():
            return self._program(video, audio)

    def _slot(self, bucket: int, video: torch.Tensor, audio: torch.Tensor) -> _Slot:
        slot = self._slots.get(bucket)
        if slot is None or slot.video.shape[1:] != video.shape[1:] \
                or slot.audio.shape[1:] != audio.shape[1:]:
            def buffer(t):
                return torch.empty((bucket, *t.shape[1:]), dtype=torch.float32,
                                   device=self.device)
            slot = self._slots[bucket] = _Slot(buffer(video), buffer(audio))
        return slot

    def _run(self, slot: _Slot) -> torch.Tensor:
        """The forward over the slot's buffers: eager on the CPU and on a
        bucket's first request under the current switches, captured on the
        second, replayed after."""
        key = _switches()
        if slot.key != key:
            slot.key, slot.warm, slot.graph, slot.out = key, False, None, None
        if slot.graph is None:
            if self.device.type != "cuda" or not slot.warm:
                slot.warm = True
                return self.forward(slot.video, slot.audio)
            graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(graph,
                                                          capture_error_mode="thread_local"):
                out = self._program(slot.video, slot.audio)
            slot.graph, slot.out = graph, out
        slot.graph.replay()
        return slot.out

    def serve(self, video, audio) -> torch.Tensor:
        """``video`` (n, T, crop, crop, 3) and ``audio`` (n, T, F, S, 1),
        normalized float, on the host (numpy or tensors) or on the device.
        Returns the per-frame probabilities (n, T, h, w, 1) on the device,
        valid until the next call. The clips go to their bucket's buffers
        and the rows past n repeat the last clip (on the device); a request
        above the largest bucket runs one eager forward at n."""
        video, audio = (torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
                        else x for x in (video, audio))
        if not (video.is_floating_point() and audio.is_floating_point()):
            raise ValueError("predict takes normalized float clips; raw uint8 frames go "
                             "through preprocess_frames first")
        n = video.shape[0]
        bucket = self._bucket(n)
        if self._replicas is not None:
            return self._serve_replicas(video, audio, n, bucket)
        with self._lock:
            if n > bucket:
                return self.forward(video.to(self.device, torch.float32),
                                    audio.to(self.device, torch.float32))
            slot = self._slot(bucket, video, audio)
            self._copy_in(slot, (video, audio), n)
            return self._run(slot)[:n]

    def _serve_replicas(self, video, audio, n: int, bucket: int) -> torch.Tensor:
        """The request over the replicas: padded to its bucket with the last
        clip (above the largest bucket, n rows split as evenly as they go),
        replica i serving the i-th share of the rows; every replica is
        launched before any answer is read."""
        k = len(self._replicas)
        if n < bucket:
            pad = bucket - n
            video = torch.cat([video, video[n - 1:n].expand(pad, *video.shape[1:])])
            audio = torch.cat([audio, audio[n - 1:n].expand(pad, *audio.shape[1:])])
        rows = video.shape[0]
        bounds = [rows * i // k for i in range(k + 1)]
        with self._lock:
            outs = [r.serve(video[a:b], audio[a:b])
                    for r, a, b in zip(self._replicas, bounds[:-1], bounds[1:]) if b > a]
            return torch.cat([o.to(self.device) for o in outs])[:n]

    def _copy_in(self, slot: _Slot, inputs, n: int) -> None:
        """The request's n clips into the slot's buffers, and rows n.. the
        last clip, copied on the device. On CUDA, clips in host memory go
        through the slot's pinned staging buffers: a copy from pageable
        memory ran at a quarter of the rate (8 flagship clips 8.00 vs 1.84
        ms, ``tools/bench_serving.py``). A staging buffer is refilled only
        once the copies out of it have run."""
        staging = self.device.type == "cuda" and not inputs[0].is_cuda
        if staging:
            if slot.stage is None:
                slot.stage = [torch.empty(buf.shape, dtype=torch.float32, pin_memory=True)
                              for buf in (slot.video, slot.audio)]
            if slot.staged is not None:
                slot.staged.synchronize()
            inputs = [st[:n].copy_(x) for st, x in zip(slot.stage, inputs)]
        bucket = slot.video.shape[0]
        for buf, x in zip((slot.video, slot.audio), inputs):
            buf[:n].copy_(x, non_blocking=True)
            if n < bucket:
                buf[n:].copy_(buf[n - 1:n].expand_as(buf[n:]))
        if staging:
            slot.staged = torch.cuda.Event()
            slot.staged.record()

    def predict(self, video: np.ndarray, audio: np.ndarray) -> Dict[str, np.ndarray]:
        """``video``: (B, T, crop, crop, 3) normalized float32 (or (T, ...) for
        one clip); ``audio``: matching (B, T, F, S, 1). Returns heatmaps
        (B, T, h, w) and gaze_xy (B, T, 2) normalized argmax points."""
        if video.ndim == 4:
            video = video[None]
            audio = audio[None] if audio.ndim == 4 else audio
        with self._lock:
            probs = self.serve(video, audio).float().cpu().numpy()[..., 0]
        b, t, h, w = probs.shape
        idx = np.argmax(probs.reshape(b, t, h * w), axis=-1)
        gaze_xy = np.stack([(idx % w + 0.5) / w, (idx // w + 0.5) / h], axis=-1).astype(np.float32)
        return {"heatmaps": probs, "gaze_xy": gaze_xy}

    # ------------------------------------------------------------------
    # the serving artifact (torch.export)
    # ------------------------------------------------------------------

    def _weights(self) -> Dict[str, torch.Tensor]:
        """Every tensor the forward reads (parameters, then buffers), by name."""
        named = dict(self.model.named_parameters())
        named.update(self.model.named_buffers())
        return {k: v.detach() for k, v in named.items()}

    def export_compiled(self, path: str, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Write this predictor as a self-contained artifact directory: one
        ``torch.export`` program per bucket (``forward_b{b}.pt2``, the
        forward and the per-frame softmax with the weights as its first
        input, so no program carries them), the weights once
        (``params.pt``, in the programs' input order) and a ``meta.json``
        with the shapes and the preprocessing constants. The kernels are
        custom ops in the programs (``csts_torch::*``), so a program runs
        them on the device it was exported on (``platforms``); the
        experiment switches are read at export. Reload with
        :meth:`from_exported`."""
        from csts_torch.train.losses import frame_softmax

        weights = self._weights()
        names, model = list(weights), self.model

        class Flat(torch.nn.Module):
            def forward(self, tensors: List[torch.Tensor], video, audio):
                params = dict(zip(names, tensors))
                logits = torch.func.functional_call(model, params, (video, audio))
                return frame_softmax(logits, temperature=2.0)

        os.makedirs(path, exist_ok=True)
        cfg = self.cfg
        t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
        fbins, win = cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW
        buckets = sorted(int(b) for b in (batch_sizes or self.batch_sizes))
        tensors = list(weights.values())
        for b in buckets:
            video = torch.zeros((b, t, s, s, 3), device=self.device)
            audio = torch.zeros((b, t, fbins, win, 1), device=self.device)
            with torch.no_grad():
                program = torch.export.export(Flat(), (tensors, video, audio))
            program.example_inputs = None  # else each program would keep a copy of the weights
            torch.export.save(program, os.path.join(path, _program_file(b)))
        torch.save(weights, os.path.join(path, ARTIFACT_WEIGHTS))
        with open(os.path.join(path, ARTIFACT_META), "w") as f:
            json.dump({
                "batch_sizes": buckets, "num_frames": t, "crop_size": s,
                "audio_freq_bins": fbins, "audio_window": win,
                "mean": self._mean, "std": self._std,
                "platforms": [self.device.type], "torch": torch.__version__,
            }, f, indent=1)

    @classmethod
    def from_exported(cls, path: str, device=None) -> "GazePredictor":
        """Load an :meth:`export_compiled` artifact: no model or config code
        runs (``cfg`` is None). It imports ``csts_torch.kernels`` for the
        custom ops the programs call. Its ``predict`` takes the same
        buckets, device padding and graphs as a live predictor's; a request
        above the largest bucket raises, as there is no program for it."""
        from csts_torch.kernels import attention, block, upsample  # noqa: F401 (the ops)

        with open(os.path.join(path, ARTIFACT_META)) as f:
            meta = json.load(f)
        device = resolve_device(device)
        if device.type not in meta["platforms"]:
            raise ValueError(f"{path} was exported for {meta['platforms']}, not {device.type}")
        weights = list(torch.load(os.path.join(path, ARTIFACT_WEIGHTS), map_location=device,
                                  weights_only=True).values())
        programs = {b: torch.export.load(os.path.join(path, _program_file(b))).module()
                    for b in meta["batch_sizes"]}

        def program(video, audio):
            b = video.shape[0]
            if b not in programs:
                raise ValueError(f"the artifact has programs for batches "
                                 f"{sorted(programs)}, not {b}")
            return programs[b](weights, video, audio)

        obj = cls.__new__(cls)
        obj.device, obj.cfg, obj.spec, obj.model = device, None, None, None
        obj._program = program
        obj._setup(meta["batch_sizes"], meta["crop_size"], meta["mean"], meta["std"])
        return obj
