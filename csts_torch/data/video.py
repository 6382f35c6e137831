"""Video clip readers with pluggable backends, the port's copy of
``csts_tpu/data/video.py`` (reference ``video_container.py:7-29`` +
``decoder.py:226-310``).

* ``npy``    -- preprocessed clips stored as ``<clip>.frames.npy`` uint8
               (T, H, W, 3) arrays (+ optional ``<clip>.meta.json``), produced
               by the offline preprocessing CLI: zero-codec reads that
               memory-map straight into the input pipeline;
* ``pyav``   -- PTS-seek selective decode (when the ``av`` package is installed);
* ``ffmpeg`` -- subprocess rawvideo pipe (when an ffmpeg binary exists);

``av`` is imported inside the reader that needs it, never when this module
is imported. The JAX package's ``opencv`` backend is not ported: the port
imports no cv2 at all (the card's machine has none), and it is a fallback
for hosts with neither PyAV nor ffmpeg.

All backends return (frames uint8 (T,H,W,3), frame indices) so label/audio
alignment is backend-independent.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_FFMPEG = shutil.which("ffmpeg")
_FFPROBE = shutil.which("ffprobe")


def _pyav():
    """The ``av`` module, or None where it is absent or a stub."""
    try:
        import av  # type: ignore
    except ImportError:
        return None
    return av if callable(getattr(av, "open", None)) else None


def available_backends():
    out = ["npy"]
    if _pyav() is not None:
        out.append("pyav")
    if _FFMPEG and _FFPROBE:
        out.append("ffmpeg")
    return out


@dataclass
class ClipMeta:
    num_frames: int
    fps: float
    duration_pts: Optional[int] = None  # pyav stream duration, if known


class VideoReader:
    """Reads a window of frames [start_frame, end_frame] from one clip file."""

    def meta(self) -> ClipMeta:
        raise NotImplementedError

    def read_window(self, start_frame: int, end_frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (frames (N,H,W,3) uint8, frame_indices (N,))."""
        raise NotImplementedError

    def close(self):
        pass


def sidecar_num_frames(path: str) -> int:
    """Zero-decode frame count from the ``pack`` sidecars: meta.json first, then
    the npy header (mmap read, no data touched). Returns 0 when no sidecar
    exists. Owns the same naming rules as :class:`NpyClipReader` so the pack
    format's layout lives in one module."""
    npy_path = path if path.endswith(".npy") else path + ".frames.npy"
    for mp in (path + ".meta.json", os.path.splitext(npy_path)[0] + ".meta.json"):
        if os.path.exists(mp):
            with open(mp) as f:
                n = int(json.load(f).get("num_frames", 0))
            if n:
                return n
    if os.path.exists(npy_path):
        return int(np.load(npy_path, mmap_mode="r").shape[0])
    return 0


class NpyClipReader(VideoReader):
    """Preprocessed-clip reader: ``<path>.frames.npy`` + optional ``<path>.meta.json``.

    For a source path ``x/clip.mp4`` the preprocessed array lives at
    ``x/clip.mp4.frames.npy`` (or the path itself if it already ends in .npy).
    """

    def __init__(self, path: str, target_fps: float = 30.0):
        npy_path = path if path.endswith(".npy") else path + ".frames.npy"
        if not os.path.exists(npy_path):
            raise FileNotFoundError(npy_path)
        self._frames = np.load(npy_path, mmap_mode="r")
        meta_path = os.path.splitext(npy_path)[0] + ".meta.json"
        alt_meta = path + ".meta.json"
        fps = target_fps
        for mp in (meta_path, alt_meta):
            if os.path.exists(mp):
                with open(mp) as f:
                    fps = float(json.load(f).get("fps", target_fps))
                break
        self._meta = ClipMeta(num_frames=int(self._frames.shape[0]), fps=fps)

    def meta(self) -> ClipMeta:
        return self._meta

    def read_window(self, start_frame: int, end_frame: int) -> Tuple[np.ndarray, np.ndarray]:
        start = max(int(start_frame), 0)
        end = min(int(end_frame), self._meta.num_frames - 1)
        idx = np.arange(start, end + 1)
        return np.asarray(self._frames[start : end + 1]), idx


class PyAVReader(VideoReader):
    """PTS-seek selective decode (decoder.py:71-108,226-310 semantics)."""

    def __init__(self, path: str):
        av = _pyav()
        if av is None:
            raise RuntimeError("PyAV is not installed")
        self._container = av.open(path)
        stream = self._container.streams.video[0]
        self._stream = stream
        self._meta = ClipMeta(
            num_frames=stream.frames,
            fps=float(stream.average_rate),
            duration_pts=stream.duration,
        )

    def meta(self) -> ClipMeta:
        return self._meta

    def read_window(self, start_frame: int, end_frame: int) -> Tuple[np.ndarray, np.ndarray]:
        m = self._meta
        timebase = (m.duration_pts or m.num_frames) / m.num_frames
        start_pts = int(start_frame * timebase)
        end_pts = int(end_frame * timebase)
        margin = 1024
        seek_offset = max(start_pts - margin, 0)
        self._container.seek(seek_offset, any_frame=False, backward=True, stream=self._stream)
        frames = {}
        for frame in self._container.decode(video=0):
            if frame.pts < start_pts:
                continue
            if frame.pts <= end_pts:
                frames[frame.pts] = frame
            else:
                break
        ordered = [frames[p] for p in sorted(frames)]
        # frame index from PTS (frame.index is deprecated in modern PyAV):
        # pts = index · (duration_pts / num_frames) ⇒ index = round(pts / timebase)
        idx = np.asarray([int(round(f.pts / timebase)) for f in ordered])
        arr = np.stack([f.to_rgb().to_ndarray() for f in ordered])
        return arr, idx

    def close(self):
        self._container.close()


class FFmpegReader(VideoReader):
    """ffmpeg-subprocess rawvideo reader with accurate input seeking: only the
    requested window is emitted (``-ss`` before ``-i`` + ``-frames:v``; ffmpeg's
    default accurate_seek decodes from the preceding keyframe and discards up to
    the exact start time)."""

    def __init__(self, path: str):
        if not (_FFMPEG and _FFPROBE):
            raise RuntimeError("ffmpeg/ffprobe not available")
        self._path = path
        probe = subprocess.run(
            [
                _FFPROBE, "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=nb_frames,avg_frame_rate,width,height",
                "-of", "json", path,
            ],
            capture_output=True, check=True,
        )
        info = json.loads(probe.stdout)["streams"][0]
        num, den = info["avg_frame_rate"].split("/")
        self._wh = (int(info["width"]), int(info["height"]))
        self._meta = ClipMeta(
            num_frames=int(info["nb_frames"]), fps=float(num) / float(den)
        )

    def meta(self) -> ClipMeta:
        return self._meta

    def read_window(self, start_frame: int, end_frame: int) -> Tuple[np.ndarray, np.ndarray]:
        w, h = self._wh
        start = max(int(start_frame), 0)
        end = min(int(end_frame), self._meta.num_frames - 1)
        n = end - start + 1
        proc = subprocess.run(
            [
                _FFMPEG, "-v", "error",
                "-ss", f"{start / self._meta.fps:.6f}", "-i", self._path,
                "-frames:v", str(n),
                "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
            ],
            capture_output=True, check=True,
        )
        frames = np.frombuffer(proc.stdout, np.uint8).reshape(-1, h, w, 3)
        idx = np.arange(start, start + frames.shape[0])
        return frames.copy(), idx


def open_clip(path: str, backend: str = "auto", target_fps: float = 30.0) -> VideoReader:
    """Backend selection with graceful fallback: npy sidecar if present, else pyav,
    else ffmpeg."""
    if backend == "auto":
        if path.endswith(".npy") or os.path.exists(path + ".frames.npy"):
            backend = "npy"
        elif _pyav() is not None:
            backend = "pyav"
        elif _FFMPEG:
            backend = "ffmpeg"
        else:
            backend = "npy"  # will raise FileNotFoundError with a clear path
    if backend == "npy":
        return NpyClipReader(path, target_fps)
    if backend == "pyav":
        return PyAVReader(path)
    if backend == "ffmpeg":
        return FFmpegReader(path)
    raise NotImplementedError(f"Unknown decoding backend {backend} (the port reads npy, pyav "
                              "and ffmpeg)")
