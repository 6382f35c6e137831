"""The host-side loader ops of ``csts_tpu/native`` (crop/flip/normalise,
audio-slice gather, gaze heatmaps) as numpy functions with the same
arithmetic as ``csts_tpu/native/loader_ops.cpp``. The port keeps no native
build of them yet (ROADMAP A.9)."""

from .ops import audio_slice_gather, fused_crop_flip_normalize, gaze_heatmaps

__all__ = ["fused_crop_flip_normalize", "audio_slice_gather", "gaze_heatmaps"]
