"""Build and load the CUDA kernels of ``csts_torch/csrc``.

Each ``*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (pointers and the
stream pass as ``c_void_p``; each C function returns ``cudaGetLastError()``).
The build happens at first use, from the sources in the checkout only, into
``build/csts_torch_kernels/`` at the repository root. A library's file name
carries a hash of its sources and flags, so an edited source never loads a
stale build. All missing libraries compile in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "csts_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library -> {C function: argument types}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "attention": {
        # 29 int64 values (see attention.cu), scale, stream
        "csts_attention_fwd": [_P, _F, _P],
    },
    "attention_bwd": {
        # dtype, q, k, v, o, g, lse, delta, lse_pad, dq, dk, dv, ws, max_chunks, B, N,
        # Lq, Lk, hd, 18 strides (q, k, v, o, g, dq), scale, stream
        "csts_attention_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_LL] * 18 + [_F, _P],
    },
    "mlp_tail": {
        # dtype, x, 8 weights, out, the scratch xn2 and G, M, C, H, Cout, LN2's
        # width, eps, stream
        "csts_mlp_tail": [_I] + [_P] * 12 + [_I] * 5 + [_F, _P],
    },
    "mlp_tail_train": {
        # dtype, x, 8 weights, dp, out, hid, the scratch xn2 and G, M, L, C, H, Cout,
        # LN2's width, eps, stream
        "csts_mlp_tail_train": [_I] + [_P] * 14 + [_I] * 6 + [_F, _P],
    },
    "upsample": {
        "csts_t2_upsample": [_I, _P, _P, _I, _I, _LL, _P],
        # dtype, x, out, B·T, H, W, C, stream
        "csts_hw2_upsample": [_I, _P, _P, _I, _I, _I, _I, _P],
    },
}
# the whole-block kernels B3, B4 and B5 share one C signature (fused_block.cuh):
# dtype, 22 input pointers and the output, q's row stride, 17 sizes, scale, stream
_FUSED_BLOCK_ARGS = [_I] + [_P] * 23 + [_LL] + [_I] * 17 + [_F, _P]
SIGNATURES.update({
    # B3, B4 and B5 also take their split's scratch buffers after the output:
    # q, av and res1, and B3 and B4 the hidden G
    "block": {"csts_fused_block": [_I] + [_P] * 27 + _FUSED_BLOCK_ARGS[24:]},
    "pool_block": {"csts_fused_pool_block": [_I] + [_P] * 27 + _FUSED_BLOCK_ARGS[24:]},
    "decoder_block": {"csts_fused_decoder_block": [_I] + [_P] * 26 + _FUSED_BLOCK_ARGS[24:]},
})

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, str]:
    """Compile every library not yet built, all in parallel, and load them.

    Returns {library: compiler output} for the ones compiled by this call
    (``-Xptxas -v`` reports registers, shared memory and spills per kernel).
    Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in SIGNATURES if n not in _libs}
    procs = {}
    for name, target in todo.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    logs, failed = {}, []
    try:
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, target)
    finally:  # interrupted: no nvcc outlives the call
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name, target in todo.items():
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return logs


def function(lib: str, fn: str):
    """The C entry point ``fn`` of library ``lib``, building it on first use."""
    if lib not in _libs:
        build_all()
    return getattr(_libs[lib], fn)


# --- what every wrapper checks before it launches -----------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def wants_grad(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether a wrapper's call is to be differentiated: grad mode on and an
    input that wants a gradient. Raises on a device other than the CPU and
    CUDA. K1, K2 and B3 then enter their autograd Functions (their
    modules' ``FusedAttention``, ``MlpTail``, ``FusedBlock``)."""
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def plain_for_autograd(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """The check of a wrapper whose kernel has no backward (B4, B5, the eval
    K3 and B9a, inference-only as in the JAX package) before its custom op,
    which has a CUDA and a CPU implementation and no autograd formula. An
    input that wants a gradient is refused on CUDA; on the CPU it sends the
    wrapper to its plain twin directly, whose autograd is PyTorch's.
    Returns True in that case."""
    if not wants_grad(name, *tensors):
        return False
    if tensors[0].device.type == "cuda":
        raise RuntimeError(_INFERENCE_ONLY.format(name=name))
    return True


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Same CUDA device and dtype for all inputs, and no input that wants a
    gradient: a wrapper launches its kernel outside autograd, so such an
    input would be cut from the graph silently. A kernel enters a training
    graph only through its ``torch.autograd.Function`` (``FusedAttention``,
    ``MlpTail``, ``FusedBlock``, ``MlpTailTrain``, ``T2Upsample`` and
    ``models/mvit.py`` ``DecoderBlockTrain``), whose forward and backward
    run with grad mode off."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: inputs must share one CUDA device and dtype")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(_INFERENCE_ONLY.format(name=name))


_INFERENCE_ONLY = ("{name}: the CUDA kernel is inference-only outside an autograd Function "
                   "(as in the JAX package); train through the block's training route")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


NO_INSTANCE = 100000  # fused_block.cuh kNoInstance


def check_launch(name: str, err: int) -> None:
    if err == NO_INSTANCE:
        raise ValueError(f"{name}: no compiled bf16 instance covers these widths")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
