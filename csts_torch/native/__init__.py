"""The host-side loader ops (``csts_tpu/native``): crop/flip/normalise,
audio-slice gather and gaze heatmaps as C++ loops (``loader_ops.cpp``), built
with g++ at first use and loaded with ctypes (``build.py``, ``ops.py``). The
dataset runs these; a failed build raises. ``twins.py`` holds numpy twins
with the loops' arithmetic, which the tests hold the ops against."""

from .build import get_lib
from .ops import audio_slice_gather, fused_crop_flip_normalize, gaze_heatmaps

__all__ = ["get_lib", "fused_crop_flip_normalize", "audio_slice_gather", "gaze_heatmaps"]
