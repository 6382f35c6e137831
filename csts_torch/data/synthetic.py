"""A synthetic dataset in the reference's on-disk layout (``ego4d_avgaze.py:95-150``,
``aria_avgaze.py``), read through the npy backend: random uint8 clips with
their meta sidecars, random STFT arrays, a gaze-label csv and the split csvs.
It lets the data path and the eval loop run end to end with nothing
downloaded.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

# per layout: clips directory, audio directory, label file suffix and header,
# split csv names, seconds a clip spans
LAYOUTS = {
    "ego4d": dict(clips="clips.gaze", audio="clips.gaze.audio_stft", label_suffix="_frame_label.csv",
                  header="frame,x,y,type", splits=("train_ego4d_gaze.csv", "test_ego4d_gaze.csv"),
                  seconds=5),
    "aria": dict(clips="clips", audio="clips.audio_24kHz_stft", label_suffix=".csv",
                 header="frame,ts,x,y,type", splits=("train_aria_gaze.csv", "test_aria_gaze.csv"),
                 seconds=5),
}


def write_dataset(root: str, layout: str = "ego4d", num_clips: int = 4, frames: int = 150,
                  res: Tuple[int, int] = (40, 56), fps: int = 30, stft_cols: int = 1000,
                  freq_bins: int = 256, seed: int = 0) -> Tuple[str, str]:
    """Writes ``num_clips`` clips of one video under ``root``; returns
    (DATA.PATH_PREFIX, DATA.PATH_TO_DATA_DIR). ``res`` is the frames' (H, W).
    Gaze points lie in [0.3, 0.7]; every fifth label frame is a saccade (type 1),
    the others fixations (type 0)."""
    spec = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    prefix = os.path.join(root, spec["clips"])
    video_name = "vid001"
    os.makedirs(os.path.join(prefix, video_name), exist_ok=True)
    os.makedirs(os.path.join(root, spec["audio"], video_name), exist_ok=True)
    os.makedirs(os.path.join(root, "gaze_frame_label"), exist_ok=True)
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)

    secs = spec["seconds"]
    rel_paths = []
    for c in range(num_clips):
        clip = f"clip{c:02d}_t{c * secs}_t{c * secs + secs}.mp4"
        rel = f"{video_name}/{clip}"
        rel_paths.append(rel)
        np.save(os.path.join(prefix, rel + ".frames.npy"),
                rng.integers(0, 256, (frames, *res, 3), dtype=np.uint8))
        with open(os.path.join(prefix, rel + ".meta.json"), "w") as f:
            json.dump({"fps": fps, "duration_pts": frames * 512}, f)
        np.save(os.path.join(root, spec["audio"], video_name, clip.replace(".mp4", ".npy")),
                rng.standard_normal((freq_bins, stft_cols)).astype(np.float32))

    total = num_clips * secs * fps + frames
    lines = [spec["header"]]
    for i in range(total):
        x, y = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)
        gtype = 0 if i % 5 else 1
        lead = f"{i}," if layout == "ego4d" else f"{i},{i / fps:.3f},"
        lines.append(f"{lead}{x:.4f},{y:.4f},{gtype}")
    with open(os.path.join(root, "gaze_frame_label", video_name + spec["label_suffix"]), "w") as f:
        f.write("\n".join(lines) + "\n")
    for split in spec["splits"]:
        with open(os.path.join(root, "splits", split), "w") as f:
            f.write("\n".join(rel_paths) + "\n")
    return prefix, os.path.join(root, "splits")
