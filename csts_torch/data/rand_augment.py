"""RandAugment and random erasing of a clip (``csts_tpu/data/rand_augment.py``;
reference ``slowfast/datasets/rand_augment.py`` and ``random_erasing.py``,
gated on ``AUG.ENABLE``).

The JAX package applies the 15 ops through PIL; the card's machine has no
PIL, so each op is written here in numpy with PIL's arithmetic (Pillow's
``libImaging``), and a seeded clip comes out equal to the JAX package's:

* the affine ops (Rotate, ShearX/Y, TranslateX/Y) sample at NEAREST, PIL's
  default: output pixel (x, y) reads input (a·x + b·y + c, d·x + e·y + f)
  at the pixel centre. Rotate and the shears take PIL's 16.16 fixed point
  (``affine_fixed``: each coefficient rounded, the coordinate floored), the
  translations its scale path (``ImagingScaleAffine``: running float64
  sums, truncated toward zero, -1 below 0); what falls outside is
  ``_FILL``. Rotate builds PIL's matrix about the image centre, cos and sin
  rounded to 15 digits;
* Color, Contrast, Brightness and Sharpness blend a degenerate image with
  the frame as ``ImageEnhance`` does (``ImagingBlend``: float32, truncated,
  clipped to [0, 255] when the factor leaves [0, 1]). Color's degenerate is
  the frame's L (ITU-R 601-2 in 16-bit fixed point, rounded), Contrast's
  the mean of L rounded, Brightness's black, Sharpness's PIL's SMOOTH
  filter (3x3, weights 1 and a centre 5, over 13, float32 sums, rounded;
  the border pixels copied as they are);
* AutoContrast, Equalize, Posterize, Solarize and Invert are per-channel
  lookup tables built as ``ImageOps`` builds them (Equalize's integer step
  included); SolarizeAdd is the JAX package's own numpy.

The generator is drawn from in the JAX package's order, so one seed gives
one policy in both packages. The same ops, levels and signs apply to every
frame of a clip (temporal consistency).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np

_FILL = (128, 128, 128)
_MAX_LEVEL = 10.0


def _randomly_negate(v: float, sign: float) -> float:
    return -v if sign > 0.5 else v


# --- the affine ops -----------------------------------------------------------


def _fix(v: float) -> int:
    """16.16 fixed point, rounded (``affine_fixed``'s FIX)."""
    return math.floor(v * 65536.0 + 0.5)


def _affine(img: np.ndarray, m) -> np.ndarray:
    """PIL's ``transform(size, AFFINE, m, NEAREST, fillcolor=_FILL)`` of an
    (H, W, 3) uint8 frame."""
    a, b, c, d, e, f = (float(v) for v in m)
    h, w = img.shape[:2]
    if b == 0 and d == 0:  # ImagingScaleAffine: running float64 sums
        xs = np.add.accumulate(np.r_[c + a * 0.5, np.full(w - 1, a)])
        ys = np.add.accumulate(np.r_[f + e * 0.5, np.full(h - 1, e)])
        xi = np.broadcast_to(np.where(xs < 0, -1, np.trunc(xs)).astype(np.int64), (h, w))
        yi = np.broadcast_to(np.where(ys < 0, -1, np.trunc(ys)).astype(np.int64)[:, None], (h, w))
    else:
        corners = [(x * a + y * b + c, x * d + y * e + f) for x in (0, w) for y in (0, h)]
        if max(abs(v) for xy in corners for v in xy) >= 32768.0:
            raise ValueError("PIL takes a float path for coordinates this large; not ported")
        # affine_fixed: 16.16 fixed point from the pixel centre, floored
        x0, y0 = _fix(c + a * 0.5 + b * 0.5), _fix(f + d * 0.5 + e * 0.5)
        xs, ys = np.arange(w)[None, :], np.arange(h)[:, None]
        xi = (x0 + ys * _fix(b) + xs * _fix(a)) >> 16
        yi = (y0 + ys * _fix(e) + xs * _fix(d)) >> 16
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.empty_like(img)
    out[...] = np.asarray(_FILL, np.uint8)
    out[inside] = img[yi[inside], xi[inside]]
    return out


def _rotate(img, level, sign):
    deg = _randomly_negate((level / _MAX_LEVEL) * 30.0, sign) % 360.0
    if deg == 0:
        return img.copy()
    if deg == 180:
        return img[::-1, ::-1].copy()
    h, w = img.shape[:2]
    if deg in (90, 270) and w == h:
        return np.rot90(img, 1 if deg == 90 else 3).copy()
    cx, cy = w / 2, h / 2
    rad = -math.radians(deg)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return _affine(img, m)


def _shear_x(img, level, sign):
    v = _randomly_negate((level / _MAX_LEVEL) * 0.3, sign)
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, level, sign):
    v = _randomly_negate((level / _MAX_LEVEL) * 0.3, sign)
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, level, sign):
    v = _randomly_negate((level / _MAX_LEVEL) * 0.45, sign) * img.shape[1]
    return _affine(img, (1, 0, v, 0, 1, 0))


def _translate_y(img, level, sign):
    v = _randomly_negate((level / _MAX_LEVEL) * 0.45, sign) * img.shape[0]
    return _affine(img, (1, 0, 0, 0, 1, v))


# --- lookup tables (ImageOps) --------------------------------------------------


def _lut(img: np.ndarray, luts) -> np.ndarray:
    """Per-channel tables (``Image.point``): ``luts`` (256,) for all
    channels or (3, 256), entries clipped to [0, 255]."""
    luts = np.broadcast_to(np.clip(luts, 0, 255).astype(np.uint8), (3, 256))  # getlist's CLIP8
    return np.stack([luts[ch][img[..., ch]] for ch in range(3)], axis=-1)


def _histograms(img: np.ndarray) -> np.ndarray:
    return np.stack([np.bincount(img[..., ch].ravel(), minlength=256) for ch in range(3)])


def _posterize(img, level, sign):
    bits = max(1, 4 - int((level / _MAX_LEVEL) * 4))
    return img & np.uint8(~(2 ** (8 - bits) - 1) & 0xFF)


def _solarize(img, level, sign):
    thresh = 256 - int((level / _MAX_LEVEL) * 256)
    i = np.arange(256)
    return _lut(img, np.where(i < thresh, i, 255 - i))


def _solarize_add(img, level, sign):
    add = int((level / _MAX_LEVEL) * 110)
    arr = img.astype(np.int32)
    return np.where(arr < 128, np.clip(arr + add, 0, 255), arr).astype(np.uint8)


def _autocontrast(img, level, sign):
    luts = []
    for h in _histograms(img):
        nz = np.flatnonzero(h)
        lo, hi = (int(nz[0]), int(nz[-1])) if nz.size else (256, -1)
        if hi <= lo:
            luts.append(np.arange(256))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append(np.clip(np.trunc(np.arange(256) * scale + offset), 0, 255))
    return _lut(img, luts)


def _equalize(img, level, sign):
    luts = []
    for h in _histograms(img):
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if histo.size > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h[:-1])])
        luts.append(n // step)
    return _lut(img, luts)


def _invert(img, level, sign):
    return 255 - img


# --- ImageEnhance ----------------------------------------------------------------


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)`` (``ImagingBlend``, float32)."""
    alpha = np.float32(factor)
    d = degenerate.astype(np.float32)
    out = d + alpha * (img.astype(np.float32) - d)
    if not 0 <= alpha <= 1:
        out = np.clip(out, 0, 255)
    return out.astype(np.uint8)


def _luma(img: np.ndarray) -> np.ndarray:
    """``convert("L")``: ITU-R 601-2 in 16-bit fixed point, rounded."""
    rgb = img.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _color_degenerate(img):
    return np.repeat(_luma(img)[..., None], 3, axis=-1)


def _contrast_degenerate(img):
    hist = np.bincount(_luma(img).ravel(), minlength=256)
    mean = int(sum(i * int(n) for i, n in enumerate(hist)) / int(hist.sum()) + 0.5)
    return np.full_like(img, mean)


def _brightness_degenerate(img):
    return np.zeros_like(img)


def _sharpness_degenerate(img):
    """``filter(ImageFilter.SMOOTH)`` (``ImagingFilter3x3``): weights 1 and
    a centre 5, each over 13 in float32, the next row's taps summed first;
    rounded and clipped; the border rows and columns copied."""
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()
    edge, centre = np.float32(1) / np.float32(13), np.float32(5) / np.float32(13)
    x = img.astype(np.float32)
    acc = np.zeros((h - 2, w - 2, 3), np.float32)
    for dy in (2, 1, 0):  # in1 (the next row), in0, in_1
        row = x[dy:dy + h - 2]
        k = (edge, centre, edge) if dy == 1 else (edge, edge, edge)
        acc += (row[:, :-2] * k[0] + row[:, 1:-1] * k[1]) + row[:, 2:] * k[2]
    out = img.copy()
    acc = acc.astype(np.float64)  # clip8's + 0.5 is a double
    out[1:-1, 1:-1] = np.where(acc <= 0, 0, np.where(acc >= 255, 255, acc + 0.5)).astype(np.uint8)
    return out


def _enhance(degenerate: Callable[[np.ndarray], np.ndarray]):
    def op(img, level, sign):
        factor = 1.0 + _randomly_negate((level / _MAX_LEVEL) * 0.9, sign)
        return _blend(degenerate(img), img, factor)

    return op


# the JAX package's order: rng.integers picks by index into it
_OPS: Dict[str, Callable] = {
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Invert": _invert,
    "Rotate": _rotate,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "SolarizeAdd": _solarize_add,
    "Color": _enhance(_color_degenerate),
    "Contrast": _enhance(_contrast_degenerate),
    "Brightness": _enhance(_brightness_degenerate),
    "Sharpness": _enhance(_sharpness_degenerate),
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
}


def parse_policy(auto_augment: str) -> Tuple[int, float, float]:
    """A timm-style spec such as ``rand-m9-n2-mstd0.5`` -> (num_ops,
    magnitude, magnitude std); "inc" is accepted (the magnitudes here
    already scale linearly)."""
    num_ops, magnitude, mstd = 2, 9.0, 0.0
    for tok in auto_augment.split("-")[1:]:
        if tok.startswith("mstd"):
            mstd = float(tok[4:])
        elif tok.startswith("m"):
            magnitude = float(tok[1:])
        elif tok.startswith("n"):
            num_ops = int(tok[1:])
    return num_ops, magnitude, mstd


def rand_augment_clip(frames: np.ndarray, auto_augment: str,
                      rng: np.random.Generator) -> np.ndarray:
    """One policy drawn from ``rng`` applied to every frame of ``frames``,
    uint8 (T, H, W, 3): the ops, then each op's level (jittered when the
    policy has an mstd), then each op's sign, in that order."""
    num_ops, magnitude, mstd = parse_policy(auto_augment)
    names = list(_OPS)
    chosen = [names[int(i)] for i in rng.integers(0, len(names), num_ops)]
    levels = []
    for _ in chosen:
        level = magnitude
        if mstd > 0:
            level = float(np.clip(rng.normal(magnitude, mstd), 0, _MAX_LEVEL))
        levels.append(level)
    signs = [float(rng.uniform()) for _ in chosen]
    out = np.empty_like(frames)
    for t in range(frames.shape[0]):
        img = frames[t]
        for name, level, sign in zip(chosen, levels, signs):
            img = _OPS[name](img, level, sign)
        out[t] = img
    return out


def random_erasing_clip(
    frames: np.ndarray,
    rng: np.random.Generator,
    prob: float = 0.25,
    area_range: Tuple[float, float] = (0.02, 1 / 3),
    aspect_range: Tuple[float, float] = (0.3, 10 / 3),
    max_count: int = 1,
) -> np.ndarray:
    """Cube-consistent random erasing (reference random_erasing.py, 'pixel'
    mode): the same region of every frame, filled with per-pixel noise."""
    if rng.uniform() >= prob:
        return frames
    t, h, w, c = frames.shape
    out = frames.copy()
    count = 1 if max_count <= 1 else int(rng.integers(1, max_count + 1))
    for _ in range(count):
        for _attempt in range(10):
            area = h * w * rng.uniform(*area_range) / count
            log_ratio = (np.log(aspect_range[0]), np.log(aspect_range[1]))
            ratio = float(np.exp(rng.uniform(*log_ratio)))
            eh = int(round(np.sqrt(area * ratio)))
            ew = int(round(np.sqrt(area / ratio)))
            if eh < h and ew < w:
                y0 = int(rng.integers(0, h - eh))
                x0 = int(rng.integers(0, w - ew))
                noise = rng.normal(0, 1, (eh, ew, c))
                if frames.dtype == np.uint8:
                    noise = np.clip(noise * 64 + 128, 0, 255).astype(np.uint8)
                out[:, y0:y0 + eh, x0:x0 + ew] = noise
                break
    return out
