"""Inference API: load once, predict gaze heatmaps at fixed batch buckets
(``csts_tpu/serving.py``).

    predictor = GazePredictor.from_checkpoint(cfg, "weights.pyth")
    out = predictor.predict(video, audio)   # dict of numpy arrays

The forward is the model at eval followed by the per-frame softmax at T=2.
It runs on CUDA unless ``device`` names another device; with no CUDA and no
device given it raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from csts_torch import resolve_device
from csts_torch.config import Config
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.train.losses import frame_softmax


class GazePredictor:
    """Batched gaze-heatmap inference with shape bucketing."""

    def __init__(
        self,
        cfg: Config,
        state_dict: Mapping[str, torch.Tensor],
        batch_sizes: Sequence[int] = (1, 8),
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = build_spec(cfg)
        model = CSTS(self.spec)
        model.load_state_dict(state_dict, strict=True)
        if cfg.TRAIN.MIXED_PRECISION:
            model = model.to(torch.bfloat16)
        self.model = model.to(self.device).eval()
        self.batch_sizes = sorted(batch_sizes)

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, **kwargs) -> "GazePredictor":
        """Load a state dict saved under the port's (the reference's) names:
        a ``torch.save``d state dict or a reference ``.pyth`` (its
        ``model_state``)."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        state = blob["model_state"] if "model_state" in blob else blob
        return cls(cfg, state, **kwargs)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def forward(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Device tensors in, per-frame heatmap probabilities (B, T, h, w, 1) out."""
        with torch.inference_mode():
            return frame_softmax(self.model(video, audio), temperature=2.0)

    def predict(self, video: np.ndarray, audio: np.ndarray) -> Dict[str, np.ndarray]:
        """``video``: (B, T, crop, crop, 3) normalized float32 (or (T, ...) for
        one clip); ``audio``: matching (B, T, F, S, 1). Returns heatmaps
        (B, T, h, w) and gaze_xy (B, T, 2) normalized argmax points."""
        if video.ndim == 4:
            video = video[None]
            audio = audio[None] if audio.ndim == 4 else audio
        n = video.shape[0]
        bucket = self._bucket(n)
        if n < bucket:
            pad = bucket - n
            video = np.concatenate([video, np.repeat(video[-1:], pad, 0)])
            audio = np.concatenate([audio, np.repeat(audio[-1:], pad, 0)])
        v = torch.from_numpy(np.ascontiguousarray(video)).to(self.device)
        a = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        probs = self.forward(v, a).float().cpu().numpy()[:n, ..., 0]
        b, t, h, w = probs.shape
        idx = np.argmax(probs.reshape(b, t, h * w), axis=-1)
        gaze_xy = np.stack([(idx % w + 0.5) / w, (idx // w + 0.5) / h], axis=-1).astype(np.float32)
        return {"heatmaps": probs, "gaze_xy": gaze_xy}
