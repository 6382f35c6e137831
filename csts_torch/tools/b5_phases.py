"""B5's phase split on the card, from clock stamps in a copy of its body:

    python -m csts_torch.tools.b5_phases [--out PATH]

``ncu`` does not run on the card's machine, so the phases are timed from
inside: thread 0 of every block reads ``clock64()`` at each phase boundary
and adds the cycles since the last stamp to that phase's sum for its block.
``decoder_block.cu`` is built as it stands, with its ``CSTS_STAMP`` hooks
defined, under ``build/b5_phases/`` with the port's nvcc flags. The hooks
sit in the back kernel (proj + skip, LN2, MLP products, output store); the
Q conv and the attention are launches of their own, timed by the profiler.

At each of B5's batch-8 sites (d2, d3, d4, the inputs of ``ab_kernels``) the
stamped library runs once to warm up, then once with the sums cleared. A
phase's share is its cycles summed over blocks (SM time) over the back
kernel's total; the profiler's device time of each of the three kernels says
how the call splits. It needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from csts_torch.kernels import _build
from csts_torch.kernels import block as kb
from csts_torch.tools.ab_kernels import B5_SITES, b5_inputs

OUT_DIR = _build.BUILD_DIR.parent / "b5_phases"
BACK_PHASES = ["proj + skip (res1)", "LN2", "MLP products", "output store"]

STAMPS = r'''#pragma once
#include <cuda_runtime.h>
#define CSTS_MAX_BLOCKS 65536
__device__ long long csts_phase[CSTS_MAX_BLOCKS][16];
__device__ long long csts_last[CSTS_MAX_BLOCKS];
// stamps 0 and 10 open a sequence; stamp k > 0 closes phase k - 1
__device__ __forceinline__ void csts_stamp(int k) {
  if (threadIdx.x != 0) return;
  const long long t = clock64();
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (k % 10 != 0) csts_phase[b][k - 1] += t - csts_last[b];
  csts_last[b] = t;
}
#define CSTS_STAMP(k) csts_stamp(k)
extern "C" int csts_read_phases(long long* sums) {
  static long long host[CSTS_MAX_BLOCKS * 16];
  cudaError_t e = cudaMemcpyFromSymbol(host, csts_phase, sizeof(host));
  if (e != cudaSuccess) return e;
  for (int k = 0; k < 16; ++k) sums[k] = 0;
  for (long long i = 0; i < (long long)CSTS_MAX_BLOCKS * 16; ++i) sums[i % 16] += host[i];
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, csts_phase);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(host));
}
'''


def build() -> ctypes.CDLL:
    """decoder_block.cu with its stamps defined, as a library of its own."""
    if OUT_DIR.exists():
        shutil.rmtree(OUT_DIR)
    OUT_DIR.mkdir(parents=True)
    for src in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "decoder_block.cu"]:
        shutil.copy(src, OUT_DIR / src.name)
    (OUT_DIR / "stamps.cuh").write_text(STAMPS)
    (OUT_DIR / "stamped.cu").write_text('#include "stamps.cuh"\n#include "decoder_block.cu"\n')
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT_DIR / "stamped.so"),
                          str(OUT_DIR / "stamped.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"b5_phases: stamped.cu failed to build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(OUT_DIR / "stamped.so"))
    lib.csts_read_phases.argtypes = [ctypes.c_void_p]
    lib.csts_read_phases.restype = ctypes.c_int
    f = lib.csts_fused_decoder_block
    f.argtypes = _build.SIGNATURES["decoder_block"]["csts_fused_decoder_block"]
    f.restype = ctypes.c_int
    return lib


def phases(lib, fn) -> list:
    fn()
    torch.cuda.synchronize()
    sums = (ctypes.c_longlong * 16)()
    _build.check_launch("b5_phases", lib.csts_read_phases(ctypes.addressof(sums)))
    fn()
    torch.cuda.synchronize()
    _build.check_launch("b5_phases", lib.csts_read_phases(ctypes.addressof(sums)))
    return list(sums)


def shares(cycles: list) -> list:
    total = sum(cycles)
    return [c / total if total else 0.0 for c in cycles]


def main(argv=None) -> int:
    from csts_torch.tools import card_line
    from csts_torch.tools.profile_forward import device_trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "b5_phases.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b5_phases: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    lib = build()
    saved = _build._libs["decoder_block"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card_line(), "sites": {}}
    try:
        for name, thw, stride, c, cout, heads in B5_SITES:
            inputs = b5_inputs(thw, stride, c, cout, heads, gen)
            with torch.inference_mode():
                _build._libs["decoder_block"] = lib
                cycles = phases(lib, lambda: kb.fused_decoder_block(*inputs))
                _build._libs["decoder_block"] = saved
                _, busy, by_name, _ = device_trace(lambda: kb.fused_decoder_block(*inputs))
            dev = {part: sum(ms for k, ms in by_name.items() if f"decoder_{part}_kernel" in k)
                   for part in ("conv", "attn", "tail")}
            site = {"back": dict(zip(BACK_PHASES, shares(cycles[10:14]))),
                    "device_ms": {**dev, "busy": busy}, "cycles": cycles}
            result["sites"][name] = site
            print(f"{name}: Q conv {dev['conv']:.4f} ms, attention {dev['attn']:.4f} ms, "
                  f"back {dev['tail']:.4f} ms (" + ", ".join(
                      f"{k} {v:.3f}" for k, v in site["back"].items()) + ")")
            del inputs
    finally:
        _build._libs["decoder_block"] = saved
    print(result["card"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
