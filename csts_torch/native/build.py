"""Build and load the native loader ops (``csts_tpu/native/build.py``).

``loader_ops.cpp`` compiles with ``g++`` at first use, from the source in the
checkout, into ``build/csts_torch_native/`` at the repository root (the
place ``kernels/_build.py`` builds the CUDA kernels), and loads with
``ctypes``. The file name carries a hash of the source and the flags, so an
edited source never loads a stale build. A failed build raises: the loader
does not fall back to numpy without being told.

The flags keep the loops' float arithmetic as written (``-ffp-contract=off``:
no fused multiply-add), so the ops give the bits of their numpy twins
(``csts_torch/native/twins.py``) on any x86 or ARM host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "loader_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "csts_torch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
VERSION = 1  # loader_ops_version() of the source

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("the native loader ops need g++ (or c++) to build")
    return path


def target() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"loader_ops_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compiles the library unless it is built; returns its path. Raises
    with the compiler's output if the compile fails."""
    so = target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([_compiler(), *FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC} (exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        dp = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(i64)
        lib.fused_crop_flip_normalize.argtypes = [
            u8p, i64, i64, i64, i64, i64, i64, ctypes.c_int, fp, fp, fp]
        lib.fused_crop_flip_normalize_f32.argtypes = [
            fp, i64, i64, i64, i64, i64, i64, ctypes.c_int, fp, fp, ctypes.c_int, fp]
        lib.audio_slice_gather.argtypes = [fp, i64, i64, ip, i64, i64, fp]
        lib.gaze_heatmaps.argtypes = [dp, i64, fp, i64, i64, i64, fp]
        lib.loader_ops_version.restype = ctypes.c_int
        if lib.loader_ops_version() != VERSION:
            raise RuntimeError(f"{SRC.name} version {lib.loader_ops_version()}, expected {VERSION}")
        _lib = lib
        return _lib
