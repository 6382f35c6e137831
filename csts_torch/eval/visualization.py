"""Visualization: prediction and label heatmap overlays and the fusion
blocks' attention maps (``csts_tpu/eval/visualization.py``; reference
``slowfast/visualization/visualization.py:9-228``).

Host-side numpy, never on the card's path. The JAX package draws with cv2,
which the card's machine lacks; the pieces it uses are written here with
cv2's arithmetic:

* :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)`` of uint8:
  half-pixel centres in float32, 11-bit fixed-point weights rounded to
  nearest even, the horizontal pass in ints, the vertical pass as cv2's
  vector body computes it (each row's sum shifted by 4, times its weight,
  the high 16 bits kept, the two added, then ``(v + 2) >> 2``), the edges
  clamped; :func:`resize_nearest` is ``INTER_NEAREST`` (floor of ``x / scale``);
* :func:`apply_colormap` is ``applyColorMap`` with cv2's JET and VIRIDIS
  tables, held below (cv2's VIRIDIS is not matplotlib's);
* :func:`add_weighted` is ``addWeighted`` of uint8 (two fused float32
  multiply-adds, rounded to nearest even, saturated); :func:`circle` is ``circle`` filled at
  LINE_8 (cv2's midpoint circle, a horizontal run per row); the frames
  are BGR, as cv2's, from :func:`rgb_to_bgr`.

Images are written as PNG through ``zlib`` (:func:`write_png`; JAX writes
its frame overlays as JPG) under the JAX package's file stems;
:func:`read_png` reads them back.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _table(hex_rows: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(hex_rows.split())), np.uint8).reshape(256, 3)


# cv2's COLORMAP_JET and COLORMAP_VIRIDIS: BGR rows for the levels 0-255
_JET_BGR = _table("""
8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc0000
c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000
ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00
ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00
ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00
ffc000ffc400ffc800ffcc00ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00
feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2eceff32caff36c6ff3ac2ff3e
beff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e
7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe
3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe
00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff
00bcff00b8ff00b4ff00b0ff00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff
007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff004cff0048ff0044ff0040ff
003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff
0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0
0000bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c000088000084000080
""")
_VIRIDIS_BGR = _table("""
5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147651347671448681648691748
6a18486c1a486d1b486e1c486f1d48701f487120487321487423487524487625487726487828487929487a2a477a2c47
7b2d477c2e477d2f477e30467e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42
86404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d8a4e3d8a4f3c8b503c8b513b
8b523b8b533a8c543a8c55398c56398c58388c59388c5a378d5b378d5c368d5d368d5e358d5f358d60348d61348d6233
8d63338e64328e65328e66318e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c
8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d288e7e278e7f278e80278e8126
8e82268e82268e83258e84258e85258e86248e87248e88238e89238d8a238d8b228d8c228d8d228d8e218d8f218d9021
8c91218c92208c92208c93208c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f
88a01f88a11f87a11f87a21f86a32086a42085a52185a62185a72284a82283a92383aa2482ab2582ac2581ad2681ad27
80ae287faf297fb02a7eb12c7db22d7cb32e7cb42f7bb5317ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d
73bc3f72bd4071be4270bf446fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c
62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d17751d17a50d27c4ed37f4dd381
4bd48449d58648d58946d68b45d68e43d79041d79340d8953ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa
30dcad2fddb02dddb22bdeb529deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5
19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f420e6f621e6f823e7fb25e7fd
""")
COLORMAPS = {"jet": _JET_BGR, "viridis": _VIRIDIS_BGR}


# --- cv2's pieces -------------------------------------------------------------


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor`` RGB2BGR (and BGR2RGB)."""
    return np.ascontiguousarray(img[..., ::-1])


def _linear_taps(src: int, dst: int):
    """cv2's source index and 11-bit weights (w0, w1) of each output index."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s, f, w0, w1


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_LINEAR)`` of a uint8
    (H, W) or (H, W, C) image; ``size`` is (width, height), as cv2's."""
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    x = img.reshape(sh, sw, -1).astype(np.int64)
    # horizontal: taps below 0 or past the end read the edge pixel whole
    sx, fx, a0, a1 = _linear_taps(sw, w)
    edge = (sx < 0) | (sx >= sw - 1)
    sx = np.clip(sx, 0, sw - 1)
    a0, a1 = np.where(edge, 2048, a0), np.where(edge, 0, a1)
    rows = x[:, sx] * a0[:, None] + x[:, np.minimum(sx + 1, sw - 1)] * a1[:, None]
    # vertical: the rows clamped, the weights as computed
    sy, _, b0, b1 = _linear_taps(sh, h)
    s0 = rows[np.clip(sy, 0, sh - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, sh - 1)] >> 4
    out = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``: output index
    i reads floor(i / (dst / src)), clamped."""
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return img[ys[:, None], xs[None, :]]


def apply_colormap(img: np.ndarray, name: str = "jet") -> np.ndarray:
    """``cv2.applyColorMap`` of a uint8 (H, W) image: (H, W, 3) BGR."""
    return COLORMAPS[name][img]


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` of uint8 images as its vector body computes it:
    fma(src1, alpha, fma(src2, beta, gamma)) with float32 coefficients, each
    fused product-sum rounded once to float32 (exact in float64 first),
    then rounded to nearest even and saturated."""
    a, b, g = (np.float64(np.float32(v)) for v in (alpha, beta, gamma))
    inner = (src2.astype(np.float64) * b + g).astype(np.float32)
    t = (src1.astype(np.float64) * a + inner).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` in place (filled,
    LINE_8): cv2's midpoint circle, each step filling the rows ±dy over
    [x - dx, x + dx] and the rows ±dx over [x - dy, x + dy], clipped to the
    image. Returns ``img``."""
    cx, cy = int(center[0]), int(center[1])
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)

    def run(y, x0, x1):
        if 0 <= y < h and x0 < w and x1 >= 0:
            img[y, max(x0, 0):min(x1, w - 1) + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            run(y, cx - dx, cx + dx)
        for y in (cy - dx, cy + dx):
            run(y, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


# --- PNG through zlib ---------------------------------------------------------------


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """A uint8 (H, W) gray or (H, W, 3) BGR image as an 8-bit PNG (stored
    as RGB, as ``cv2.imwrite`` stores a BGR array)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = rgb_to_bgr(img) if img.ndim == 3 else img
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The inverse of :func:`write_png`: a BGR (or gray) uint8 array. Reads
    8-bit gray or RGB PNGs whose rows take filter 0, as it writes them;
    raises on any other."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray or RGB, not interlaced (got {header})")
    cn = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * cn)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    img = raw[:, 1:].reshape(h, w, cn)
    return rgb_to_bgr(img) if cn == 3 else img[..., 0].copy()


# --- the JAX package's functions --------------------------------------------------


def _to_uint8_frame(frame: np.ndarray, mean, std) -> np.ndarray:
    """Undo tensor_normalize: (H, W, 3) float -> uint8 BGR."""
    img = frame * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return rgb_to_bgr(img)


def heatmap_overlay(frame_u8: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """A heatmap min-max scaled, resized to the frame (INTER_LINEAR),
    coloured with JET and blended over the BGR frame (vis_inference :9-73)."""
    h, w = frame_u8.shape[:2]
    hm = heatmap.astype(np.float32)
    hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-8)
    hm_u8 = resize_linear((hm * 255).astype(np.uint8), (w, h))
    return add_weighted(frame_u8, 1 - alpha, apply_colormap(hm_u8, "jet"), alpha, 0)


def vis_inference(
    out_dir: str,
    video: np.ndarray,  # (T, H, W, 3) normalized
    preds: np.ndarray,  # (T, h, w)
    labels_hm: np.ndarray,  # (T, h, w)
    mean=(0.45, 0.45, 0.45),
    std=(0.225, 0.225, 0.225),
    prefix: str = "clip",
) -> None:
    """Side-by-side prediction/label overlays per frame, ``<prefix>_fTT.png``
    (visualization.py:9-73)."""
    os.makedirs(out_dir, exist_ok=True)
    for t in range(video.shape[0]):
        frame = _to_uint8_frame(video[t], mean, std)
        side = np.concatenate([heatmap_overlay(frame, preds[t]),
                               heatmap_overlay(frame, labels_hm[t])], axis=1)
        write_png(os.path.join(out_dir, f"{prefix}_f{t:02d}.png"), side)


def vis_spatial_attention(
    out_dir: str,
    video: np.ndarray,  # (T, H, W, 3) normalized
    spatial_attn: np.ndarray,  # (num_heads, L, L) fp32 from the spatial-fusion block
    thw,
    mean=(0.45, 0.45, 0.45),
    std=(0.225, 0.225, 0.225),
) -> None:
    """Per head and fusion frame f, the audio token's attention over frame
    f's video tokens over the frame, ``attn_hN_fF.png`` (vis_av_st_fusion,
    visualization.py:172-228)."""
    os.makedirs(out_dir, exist_ok=True)
    t_grid, h_grid, w_grid = thw
    hw = h_grid * w_grid
    frames_per_grid = video.shape[0] // t_grid
    for head in range(spatial_attn.shape[0]):
        for f in range(t_grid):
            attn_map = spatial_attn[head, t_grid * hw + f, hw * f:hw * (f + 1)]
            frame = _to_uint8_frame(video[min(f * frames_per_grid, video.shape[0] - 1)],
                                    mean, std)
            write_png(os.path.join(out_dir, f"attn_h{head}_f{f}.png"),
                      heatmap_overlay(frame, attn_map.reshape(h_grid, w_grid)))


def vis_video(
    out_dir: str,
    all_frames: np.ndarray,  # (T_full, H, W, 3) uint8 RGB — the clip at full rate
    frame_indices: np.ndarray,  # (T,) full-rate index of each model output step
    preds: np.ndarray,  # (T, h, w) rescaled predictions
    labels: Optional[np.ndarray] = None,  # (T, 3) normalized (x, y, type)
    prefix: str = "hm",
    crop_square: bool = True,
    size: int = 256,
) -> None:
    """Every full-rate frame between the first and last sampled step with the
    prediction of its nearest model step, centre-cropped square and resized,
    the label's gaze point as a green dot, ``<prefix>_<frame>.png``
    (visualization.py:76-133)."""
    os.makedirs(out_dir, exist_ok=True)
    frame_indices = np.asarray(frame_indices).astype(int)
    lo, hi = int(frame_indices.min()), int(frame_indices.max())
    hi = min(hi, all_frames.shape[0] - 1)
    for j in range(lo, hi + 1):
        step = int(np.argmin(np.abs(frame_indices - j)))
        frame = all_frames[min(j, all_frames.shape[0] - 1)]
        if crop_square:
            h, w = frame.shape[:2]
            if w > h:
                frame = frame[:, (w - h) // 2:(w - h) // 2 + h]
            elif h > w:
                frame = frame[(h - w) // 2:(h - w) // 2 + w]
        frame = rgb_to_bgr(resize_linear(frame, (size, size)))
        vis = heatmap_overlay(frame, preds[step], alpha=0.4)
        if labels is not None:
            circle(vis, (int(labels[step, 0] * size), int(labels[step, 1] * size)), 5, (0, 255, 0))
        write_png(os.path.join(out_dir, f"{prefix}_{j:05d}.png"), vis)


def vis_video_forecasting(
    out_dir: str,
    all_frames: np.ndarray,  # (T_full, H, W, 3) uint8 RGB
    label_indices: np.ndarray,  # (T,) FUTURE frame index of each forecast step
    preds: np.ndarray,  # (T, h, w)
    labels: Optional[np.ndarray] = None,
    prefix: str = "hm",
    size: int = 256,
) -> None:
    """Forecasts over the future frames they anticipate (visualization.py:136-169):
    :func:`vis_video` at the dataset's forecast label indices."""
    vis_video(out_dir, all_frames, label_indices, preds, labels, prefix=prefix, size=size)


def vis_temporal_attention(out_dir: str, temporal_attn: np.ndarray) -> None:
    """Each head's (2T, 2T) temporal-fusion attention, min-max scaled,
    resized to 256x256 (INTER_NEAREST) and coloured with VIRIDIS,
    ``temporal_attn_hN.png`` (visualization.py:214-228)."""
    os.makedirs(out_dir, exist_ok=True)
    for head in range(temporal_attn.shape[0]):
        m = temporal_attn[head]
        m = (m - m.min()) / (m.max() - m.min() + 1e-8)
        img = resize_nearest((m * 255).astype(np.uint8), (256, 256))
        write_png(os.path.join(out_dir, f"temporal_attn_h{head}.png"),
                  apply_colormap(img, "viridis"))
