"""The offline preprocessing CLI (``csts_tpu/data/preprocess.py``; reference
``data/preprocess.py:14-353``).

Stages (``python -m csts_torch.data.preprocess <stage> --help``), each
writing the on-disk layout the datasets read:

* ``trim``   — cut source videos into 5 s clips (Ego4D: non-overlapping,
               skipping untracked intervals; Aria: overlapping at a 2 s
               stride) with the ffmpeg binary; raises without it;
* ``audio``  — extract mono 24 kHz wav with the ffmpeg binary; raises
               without it;
* ``stft``   — wav -> log-power STFT ``.npy`` (``data/stft.py``
               ``stft_numpy``, the JAX package's bits);
* ``pack``   — decode every clip once into ``<clip>.frames.npy`` uint8 and
               ``.meta.json``, resized with cv2's INTER_LINEAR arithmetic
               (``eval/visualization.py`` ``resize_linear``; no cv2 here);
* ``splits`` — train/test split CSVs and the video-id list from a clip tree;
* ``check``  — validate a prepared tree against its split CSVs through the
               port's own dataset variants (``data/datasets.py``).

The per-frame gaze labels (Ego4D: nearest timestamp, saccade > 40 px at
1080p; Aria: 10 -> 20 Hz interpolation, the axis swap, saccade 24 px) are
:func:`ego4d_frame_labels` and :func:`aria_frame_labels`, written by
:func:`write_frame_label_csv`; as in the JAX module no stage drives them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np

from csts_torch.data import stft as stft_lib
from csts_torch.data import video as video_lib
from csts_torch.eval.visualization import resize_linear

EGO4D_SACCADE_PX = 40.0  # @1080p (preprocess.py:137)
ARIA_SACCADE_PX = 24.0  # @1408 (preprocess.py:226)
ARIA_RES = 1408.0

# gaze_type codes (preprocess.py:98-158)
GAZE_FIXATION = 0
GAZE_SACCADE = 1
GAZE_TRIMMED = 2
GAZE_UNTRACKED = 3


# ----------------------------------------------------------------------------------
# clip trimming
# ----------------------------------------------------------------------------------

# The 4 Ego4D videos the reference skips (preprocess.py:39-43)
EGO4D_SKIP_VIDEOS = {
    "4e07da0c-450f-4c37-95e9-e793cb5d8f7f.mp4",
    "5819e52c-4e12-4f86-ad69-76fc215dfbcb.mp4",
    "83081c5a-8456-44d8-af67-280034f8f0a6.mp4",
    "a77682da-cae7-4e68-8580-6cb47658b23f.mp4",
}


def parse_untracked_csv(path: str) -> dict:
    """ego4d_gaze_untracked.csv: video, hh:mm:ss start/end intervals
    (preprocess.py:25-36). Returns {video_stem: [(start_s, end_s), ...]}."""
    import csv as _csv

    out: dict = {}
    with open(path) as f:
        for line in _csv.reader(f):
            h0, m0, s0 = line[1].split(":")
            h1, m1, s1 = line[2].split(":")
            start = int(h0) * 3600 + int(m0) * 60 + int(s0)
            end = int(h1) * 3600 + int(m1) * 60 + int(s1)
            out.setdefault(line[0], []).append((start, end))
    return out


def ego4d_trim_windows(duration: float, untracked: Optional[List[Tuple[float, float]]] = None):
    """Non-overlapping 5 s windows, skipping any window touching an untracked
    interval (preprocess.py:54-66). Yields (start, end, clip_name_suffix)."""
    for i in range(0, int(duration), 5):
        start, end = i, i + 5
        if end > duration:
            break
        if untracked and any(not (end < a or start > b) for a, b in untracked):
            continue
        yield start, end, f"t{start}_t{end}"


def aria_trim_windows(duration: float):
    """Overlapping 5 s windows at 2 s stride; NOTE the reference names them
    ``t{start}_t{end-1}`` (preprocess.py:91-95)."""
    for i in range(0, int(duration), 2):
        start, end = i, i + 5
        if end > duration:
            break
        yield start, end, f"t{start}_t{end - 1}"


def trim_video(video_path: str, out_dir: str, windows) -> List[str]:
    """Cut windows with ffmpeg (stream re-encode like the reference's moviepy path)."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError("ffmpeg binary not available on this host")
    vid = os.path.splitext(os.path.basename(video_path))[0]
    os.makedirs(os.path.join(out_dir, vid), exist_ok=True)
    written = []
    for start, end, suffix in windows:
        dst = os.path.join(out_dir, vid, f"{vid}_{suffix}.mp4")
        subprocess.run(
            [ffmpeg, "-y", "-v", "error", "-ss", str(start), "-to", str(end),
             "-i", video_path, "-an", dst],
            check=True,
        )
        written.append(dst)
    return written


# ----------------------------------------------------------------------------------
# frame labels
# ----------------------------------------------------------------------------------


def ego4d_frame_labels(
    gaze_ts: np.ndarray,
    gaze_xy: np.ndarray,
    num_frames: int,
    fps: float,
    untracked: Optional[List[Tuple[float, float]]] = None,
    saccade_px: float = EGO4D_SACCADE_PX,
    res_h: float = 1080.0,
) -> np.ndarray:
    """Per-frame [x, 1−y, type] via nearest gaze timestamp (preprocess.py:98-158).

    ``gaze_ts``: (N,) seconds; ``gaze_xy``: (N, 2) normalized [x, y]; returns
    (num_frames, 3) with y flipped to image coordinates and saccades flagged when the
    inter-frame gaze movement exceeds ``saccade_px`` at ``res_h``.
    """
    frame_t = np.arange(num_frames) / fps
    idx = np.searchsorted(gaze_ts, frame_t)
    idx = np.clip(idx, 0, len(gaze_ts) - 1)
    prev = np.clip(idx - 1, 0, len(gaze_ts) - 1)
    take_prev = np.abs(gaze_ts[prev] - frame_t) < np.abs(gaze_ts[idx] - frame_t)
    nearest = np.where(take_prev, prev, idx)
    xy = gaze_xy[nearest]
    out = np.zeros((num_frames, 3), np.float64)
    out[:, 0] = xy[:, 0]
    out[:, 1] = 1.0 - xy[:, 1]  # flip to image convention (preprocess.py:128)
    # saccade detection on consecutive frames
    d = np.zeros(num_frames)
    d[1:] = np.linalg.norm((xy[1:] - xy[:-1]) * res_h, axis=1)
    out[:, 2] = np.where(d > saccade_px, GAZE_SACCADE, GAZE_FIXATION)
    # out-of-frame
    off = (out[:, 0] < 0) | (out[:, 0] > 1) | (out[:, 1] < 0) | (out[:, 1] > 1)
    out[off, 2] = GAZE_TRIMMED
    if untracked:
        for t0, t1 in untracked:
            mask = (frame_t >= t0) & (frame_t <= t1)
            out[mask, 2] = GAZE_UNTRACKED
    return out


def aria_frame_labels(
    gaze_ts: np.ndarray,
    gaze_xy_px: np.ndarray,
    num_frames: int,
    fps: float = 20.0,
    saccade_px: float = ARIA_SACCADE_PX,
) -> np.ndarray:
    """Aria per-frame labels: 10 Hz gaze linearly interpolated to frame times, axis
    swap (x, y) → (1 − y/1408, x/1408) (preprocess.py:161-244)."""
    frame_t = np.arange(num_frames) / fps
    x = np.interp(frame_t, gaze_ts, gaze_xy_px[:, 0])
    y = np.interp(frame_t, gaze_ts, gaze_xy_px[:, 1])
    out = np.zeros((num_frames, 3), np.float64)
    out[:, 0] = 1.0 - y / ARIA_RES
    out[:, 1] = x / ARIA_RES
    d = np.zeros(num_frames)
    d[1:] = np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2)
    out[:, 2] = np.where(d > saccade_px, GAZE_SACCADE, GAZE_FIXATION)
    off = (out[:, 0] < 0) | (out[:, 0] > 1) | (out[:, 1] < 0) | (out[:, 1] > 1)
    out[off, 2] = GAZE_TRIMMED
    return out


def write_frame_label_csv(path: str, labels: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("frame,x,y,type\n")
        for i, row in enumerate(labels):
            f.write(f"{i},{row[0]:.6f},{row[1]:.6f},{int(row[2])}\n")


# ----------------------------------------------------------------------------------
# audio
# ----------------------------------------------------------------------------------


def extract_audio(video_path: str, wav_path: str, sample_rate: int = 24000) -> None:
    """ffmpeg → mono pcm_s16le wav (preprocess.py:247-273)."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError("ffmpeg binary not available on this host")
    subprocess.run(
        [ffmpeg, "-y", "-v", "error", "-i", video_path,
         "-ac", "1", "-ar", str(sample_rate), "-acodec", "pcm_s16le", wav_path],
        check=True,
    )


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Minimal PCM wav reader (no scipy/librosa dependency)."""
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise NotImplementedError(f"sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


def audio_stft_file(wav_path: str, npy_path: str) -> None:
    """wav → log-power STFT .npy (preprocess.py:276-304 parity)."""
    samples, sr = load_wav(wav_path)
    spec = stft_lib.stft_numpy(samples, sr)
    np.save(npy_path, spec)


# ----------------------------------------------------------------------------------
# clip packing (decode once)
# ----------------------------------------------------------------------------------


def pack_clip(video_path: str, short_side: Optional[int] = None) -> str:
    """Decode a clip once and store raw uint8 frames + meta next to it; with
    ``short_side``, frames whose short side is longer are first resized to
    it (cv2's INTER_LINEAR of uint8, ``visualization.resize_linear``)."""
    reader = video_lib.open_clip(video_path, backend="auto")
    meta = reader.meta()
    frames, _ = reader.read_window(0, meta.num_frames - 1)
    reader.close()
    if short_side:
        t, h, w, c = frames.shape
        if min(h, w) > short_side:
            if h < w:
                nh, nw = short_side, int(round(w * short_side / h))
            else:
                nh, nw = int(round(h * short_side / w)), short_side
            frames = np.stack(
                [resize_linear(f, (nw, nh)) for f in frames]
            )
    out = video_path + ".frames.npy"
    np.save(out, frames)
    with open(video_path + ".meta.json", "w") as f:
        json.dump(
            {"fps": meta.fps, "num_frames": int(frames.shape[0]),
             "duration_pts": meta.duration_pts}, f,
        )
    return out


# ----------------------------------------------------------------------------------
# split CSVs (the experiment manifests the reference ships as data/*.csv)
# ----------------------------------------------------------------------------------


def parse_clip_window(clip_name: str) -> Optional[Tuple[int, int]]:
    """``<stem>_t{start}_t{x}.mp4`` → (start_s, start_s + 5). Both naming schemes
    (Ego4D ``t{s}_t{s+5}``, Aria ``t{s}_t{s+4}`` — end-1, preprocess.py:91-95)
    denote a 5 s window starting at ``start``."""
    stem = os.path.basename(clip_name)
    if stem.endswith(".mp4"):
        stem = stem[:-4]
    parts = stem.rsplit("_t", 2)
    if len(parts) != 3:
        return None
    try:
        start = int(parts[1])
        int(parts[2])
    except ValueError:
        return None
    return start, start + 5


def scan_clip_tree(clips_dir: str) -> dict:
    """{video_id: [relative clip paths]} from a ``<root>/<vid>/<clip>.mp4`` tree.

    Accepts real ``.mp4`` files and packed ``<clip>.mp4.frames.npy`` sidecars
    (the tree the ``pack`` stage leaves behind when the source clips were
    deleted), deduplicated to the ``.mp4``-relative path the split CSVs use."""
    videos: dict = {}
    for vid in sorted(os.listdir(clips_dir)):
        vdir = os.path.join(clips_dir, vid)
        if not os.path.isdir(vdir):
            continue
        rels = set()
        for name in os.listdir(vdir):
            if name.endswith(".mp4"):
                rels.add(f"{vid}/{name}")
            elif name.endswith(".mp4.frames.npy"):
                rels.add(f"{vid}/{name[: -len('.frames.npy')]}")
        if rels:
            videos[vid] = sorted(rels)
    return videos


def make_splits(
    videos: dict,
    test_videos: Optional[set] = None,
    test_fraction: float = 0.2,
    seed: int = 42,
    untracked: Optional[dict] = None,
    skip_videos: Optional[set] = None,
) -> Tuple[List[str], List[str], List[str]]:
    """Assign whole videos to train/test and emit the clip manifests.

    The reference's split is by VIDEO, never by clip (every ``<vid>/...`` path in
    ``data/train_ego4d_gaze.csv`` belongs to a video absent from the test CSV) —
    splitting by clip would leak temporally adjacent frames across the boundary.
    ``test_videos`` pins the assignment explicitly (how the reference's own split
    is reproduced); otherwise a seeded shuffle of the sorted video ids holds out
    ``test_fraction`` of them. Clips overlapping an untracked-gaze interval are
    dropped (belt and braces — ``trim`` already skips them, but pre-trimmed clip
    trees may not have).

    Returns (train_rels, test_rels, video_ids), each sorted like the reference's
    CSVs (lexicographic).
    """
    ids = [v for v in sorted(videos) if not (skip_videos and f"{v}.mp4" in skip_videos)]
    if test_videos is None:
        order = list(ids)
        np.random.default_rng(seed).shuffle(order)
        n_test = max(1, int(round(len(order) * test_fraction))) if order else 0
        test_videos = set(order[:n_test])
    train_rels, test_rels = [], []
    for vid in ids:
        rels = videos[vid]
        if untracked and vid in untracked:
            kept = []
            for rel in rels:
                win = parse_clip_window(rel)
                # Inclusive-boundary overlap on BOTH ends, matching the
                # reference's trim test exactly (preprocess.py:61 `not (end <
                # interval[0] or start > interval[1])`): a clip whose exclusive
                # end merely touches an interval start is dropped there too, so
                # the generated manifests reproduce the reference's clip set.
                if win and any(not (win[1] < a or win[0] > b) for a, b in untracked[vid]):
                    continue
                kept.append(rel)
            rels = kept
        (test_rels if vid in test_videos else train_rels).extend(rels)
    return sorted(train_rels), sorted(test_rels), ids


def write_splits(
    out_dir: str, dataset: str, train_rels: List[str], test_rels: List[str],
    video_ids: List[str],
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, rows in (
        (f"train_{dataset}_gaze.csv", train_rels),
        (f"test_{dataset}_gaze.csv", test_rels),
        (f"{dataset}_video_ids.txt", video_ids),
    ):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        written.append(path)
    return written


# ----------------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------------


def check_data_tree(
    prefix: str, data_dir: str, dataset: str, target_fps: Optional[int] = None
) -> dict:
    """Validate a prepared data tree against its split manifests BEFORE training.

    For every clip named by the variant's train/test CSVs, verifies what the
    dataset will need at runtime (``datasets.py`` `_construct`/`__getitem__`,
    whose path rules are SHARED via ``VariantSpec.{audio_path,video_name,
    label_path}`` so this validator cannot drift from the loader): a video
    source (container or packed ``.frames.npy`` + ``.meta.json``), the audio
    STFT ``.npy``, the per-video gaze label file, and — when a packed clip's
    frame count is cheap to read (npy header only) — that the label file
    covers the clip's global frame range. The range uses the dataset's
    TARGET_FPS exactly like the loader (``labels_global = tstart*TARGET_FPS +
    native frame index``, datasets.py:294-314), NOT the clip's native fps;
    pass ``target_fps`` if the run overrides ``DATA.TARGET_FPS``. Returns
    ``{"clips", "videos", "problems"}``; the CLI stage exits nonzero on any
    problem. The reference has no such tool — its failure mode is a mid-epoch
    crash in a loader worker.
    """
    from csts_torch.data.datasets import _VARIANTS

    variant = _VARIANTS[dataset]
    if target_fps is None:
        target_fps = 20 if dataset.startswith("aria") else 30  # the shipped recipes
    root = os.path.dirname(prefix)
    problems: List[str] = []
    clips = 0
    label_rows: dict = {}  # video_name -> row count (or -1 if missing)
    for csv_name in sorted({variant.train_csv, variant.test_csv}):
        manifest = os.path.join(data_dir, csv_name)
        if not os.path.exists(manifest):
            problems.append(f"missing split manifest {manifest}")
            continue
        with open(manifest) as f:
            rels = [r for r in f.read().splitlines() if r]
        if not rels:
            problems.append(f"empty split manifest {manifest}")
        for rel in rels:
            clips += 1
            if "/" not in rel:
                problems.append(f"{rel}: manifest row has no <video>/<clip> directory")
                continue
            vpath = os.path.join(prefix, rel)
            has_container = os.path.exists(vpath)
            packed = vpath + ".frames.npy"
            has_npy = os.path.exists(packed)
            if not (has_container or has_npy):
                problems.append(f"{rel}: no video container or packed .frames.npy")
            if has_npy and not os.path.exists(vpath + ".meta.json"):
                problems.append(f"{rel}: packed frames without .meta.json (fps/pts)")

            apath = variant.audio_path(vpath)
            if not os.path.exists(apath):
                problems.append(f"{rel}: missing audio STFT {os.path.relpath(apath, root)}")

            video_name = variant.video_name(vpath)
            if video_name not in label_rows:
                lpath = variant.label_path(root, video_name)
                if os.path.exists(lpath):
                    with open(lpath) as f:
                        label_rows[video_name] = sum(1 for _ in f) - 1  # minus header
                else:
                    label_rows[video_name] = -1
                    problems.append(f"{video_name}: missing gaze label file {lpath}")

            window = parse_clip_window(rel)
            if has_npy and label_rows.get(video_name, -1) >= 0 and window:
                n_frames = np.load(packed, mmap_mode="r").shape[0]
                needed = int(window[0] * target_fps) + n_frames
                if label_rows[video_name] < needed:
                    problems.append(
                        f"{rel}: label file has {label_rows[video_name]} rows but the "
                        f"clip's global frame range ends at {needed} "
                        f"(tstart {window[0]}s x TARGET_FPS {target_fps} + {n_frames} frames)"
                    )
    return {"clips": clips, "videos": len(label_rows), "problems": problems}


def main(argv=None):
    parser = argparse.ArgumentParser(description="CSTS offline preprocessing (the port's)")
    sub = parser.add_subparsers(dest="stage", required=True)

    p_stft = sub.add_parser("stft", help="wav dir -> log-power STFT .npy dir")
    p_stft.add_argument("--input", required=True)
    p_stft.add_argument("--output", required=True)
    p_stft.add_argument("--workers", type=int, default=1,
                        help="parallel worker processes (per-file fan-out)")

    p_audio = sub.add_parser("audio", help="extract 24kHz mono wav from clips")
    p_audio.add_argument("--input", required=True)
    p_audio.add_argument("--output", required=True)
    p_audio.add_argument("--workers", type=int, default=1)

    p_pack = sub.add_parser("pack", help="decode clips to .frames.npy sidecars")
    p_pack.add_argument("--input", required=True)
    p_pack.add_argument("--short-side", type=int, default=320,
                        help="downscale so augmentation never upsamples (0 = keep)")
    p_pack.add_argument("--workers", type=int, default=1)

    p_splits = sub.add_parser(
        "splits", help="emit train/test split CSVs + video-id list from a clip tree"
    )
    p_splits.add_argument("--clips", required=True, help="trimmed clip tree <root>/<vid>/*.mp4")
    p_splits.add_argument("--output", required=True, help="directory for the CSVs (DATA.PATH_TO_DATA_DIR)")
    p_splits.add_argument("--dataset", choices=("ego4d", "aria"), required=True)
    p_splits.add_argument("--test-videos", default=None,
                          help="file of video ids held out for test (one per line); "
                               "omit for a seeded test-fraction split")
    p_splits.add_argument("--test-fraction", type=float, default=0.2)
    p_splits.add_argument("--seed", type=int, default=42)
    p_splits.add_argument("--untracked-csv", default=None,
                          help="ego4d_gaze_untracked.csv — drop clips overlapping untracked gaze")

    p_check = sub.add_parser(
        "check", help="validate a prepared data tree against its split manifests"
    )
    p_check.add_argument("--prefix", required=True, help="DATA.PATH_PREFIX (the clip tree)")
    p_check.add_argument("--data-dir", required=True, help="DATA.PATH_TO_DATA_DIR (split CSVs)")
    p_check.add_argument(
        "--dataset", required=True,
        choices=("ego4d_av_gaze", "ego4d_av_gaze_forecast", "aria_av_gaze", "aria_av_gaze_forecast"),
        help="TRAIN/TEST.DATASET name (fixes the audio path rule + label format)",
    )
    p_check.add_argument("--target-fps", type=int, default=None,
                         help="DATA.TARGET_FPS of the run (default: the dataset's "
                              "shipped recipe — 30 Ego4D / 20 Aria); label frame "
                              "ranges are computed at this rate like the loader")
    p_check.add_argument("--max-print", type=int, default=20)

    p_trim = sub.add_parser("trim", help="cut source videos into 5s clips")
    p_trim.add_argument("--input", required=True)
    p_trim.add_argument("--output", required=True)
    p_trim.add_argument("--dataset", choices=("ego4d", "aria"), required=True)
    p_trim.add_argument("--untracked-csv", default=None,
                        help="ego4d_gaze_untracked.csv (Ego4D only)")

    args = parser.parse_args(argv)

    def _run_jobs(jobs):
        """Per-file fan-out: the stft/audio/pack stages are embarrassingly
        parallel over 10k+ clips (the reference preprocesses serially,
        data/preprocess.py:307-353). --workers N uses a process pool (numpy
        FFT, decode and resize are CPU-bound); 1 keeps the serial order."""
        if getattr(args, "workers", 1) <= 1:
            for fn, fnargs, out in jobs:
                fn(*fnargs)
                print(out)
            return
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        # spawn, not fork: an in-process caller may run thread pools (torch's),
        # and fork() under threads risks deadlocked workers
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=args.workers, mp_context=ctx) as pool:
            futs = {pool.submit(fn, *fnargs): out for fn, fnargs, out in jobs}
            for fut in as_completed(futs):
                fut.result()  # surface worker exceptions
                print(futs[fut])

    if args.stage == "stft":
        jobs = []
        for root, _, files in os.walk(args.input):
            for name in files:
                if not name.endswith(".wav"):
                    continue
                rel = os.path.relpath(os.path.join(root, name), args.input)
                dst = os.path.join(args.output, rel.replace(".wav", ".npy"))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                jobs.append((audio_stft_file, (os.path.join(root, name), dst), dst))
        _run_jobs(jobs)
    elif args.stage == "audio":
        jobs = []
        for root, _, files in os.walk(args.input):
            for name in files:
                if not name.endswith(".mp4"):
                    continue
                rel = os.path.relpath(os.path.join(root, name), args.input)
                dst = os.path.join(args.output, rel.replace(".mp4", ".wav"))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                jobs.append((extract_audio, (os.path.join(root, name), dst), dst))
        _run_jobs(jobs)
    elif args.stage == "pack":
        jobs = []
        for root, _, files in os.walk(args.input):
            for name in files:
                if not name.endswith(".mp4"):
                    continue
                src = os.path.join(root, name)
                jobs.append(
                    (pack_clip, (src, args.short_side or None), src + ".frames.npy")
                )
        _run_jobs(jobs)
    elif args.stage == "splits":
        test_videos = None
        if args.test_videos:
            with open(args.test_videos) as f:
                test_videos = {line.strip() for line in f if line.strip()}
        untracked = parse_untracked_csv(args.untracked_csv) if args.untracked_csv else None
        skip = EGO4D_SKIP_VIDEOS if args.dataset == "ego4d" else None
        videos = scan_clip_tree(args.clips)
        train_rels, test_rels, ids = make_splits(
            videos, test_videos=test_videos, test_fraction=args.test_fraction,
            seed=args.seed, untracked=untracked, skip_videos=skip,
        )
        for path in write_splits(args.output, args.dataset, train_rels, test_rels, ids):
            print(path)
        print(f"# {len(train_rels)} train / {len(test_rels)} test clips over {len(ids)} videos",
              file=sys.stderr)
    elif args.stage == "check":
        report = check_data_tree(args.prefix, args.data_dir, args.dataset,
                                 target_fps=args.target_fps)
        for p in report["problems"][: args.max_print]:
            print(f"PROBLEM: {p}")
        extra = len(report["problems"]) - args.max_print
        if extra > 0:
            print(f"... and {extra} more")
        print(
            f"# {report['clips']} manifest clips over {report['videos']} videos: "
            f"{len(report['problems'])} problem(s)",
            file=sys.stderr,
        )
        return 1 if report["problems"] else 0
    elif args.stage == "trim":
        untracked = parse_untracked_csv(args.untracked_csv) if args.untracked_csv else {}
        for name in sorted(os.listdir(args.input)):
            if not name.endswith(".mp4"):
                continue
            if args.dataset == "ego4d" and name in EGO4D_SKIP_VIDEOS:
                continue
            src = os.path.join(args.input, name)
            reader = video_lib.open_clip(src, backend="auto")
            meta = reader.meta()
            duration = meta.num_frames / meta.fps
            reader.close()
            vid = os.path.splitext(name)[0]
            if args.dataset == "ego4d":
                windows = ego4d_trim_windows(duration, untracked.get(vid))
            else:
                windows = aria_trim_windows(duration)
            for dst in trim_video(src, args.output, windows):
                print(dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
