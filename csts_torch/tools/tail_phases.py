"""K2's and B7's three kernels (LN2, fc1 + GELU, fc2 + proj) one by one, at
the flagship's tail sites at batch 8, beside cuBLAS's products alone:

    python -m csts_torch.tools.tail_phases [--out PATH]

Each site runs K2 (``kb.fused_mlp_tail``) and B7 (``kb.fused_mlp_tail_train``,
drop-path factors of one) once under ``torch.profiler`` and reports each
device kernel's time, then times ``torch.mm`` of fc1, fc2 and the dim-change
proj on operands of the same shapes (``profile_forward.device_ms``), and the
sites' operations at the card's bf16 peak. Inputs are random bf16 from a
seed. The result goes to ``--out``; the card's name and power limit are
printed beside it. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

# (name, rows at batch 8, C, H, C_out): the sites whose split the tail's
# design turns on (v4-v12, v13, v14/v15/a3, the spatial fusion, and B7's
# widest d2 and d4)
SITES = [
    ("v4", 8192, 384, 1536, 384), ("v13", 8192, 384, 1536, 768),
    ("v14", 2048, 768, 3072, 768), ("spatial fusion", 2080, 768, 3072, 768),
    ("d2", 32768, 768, 1536, 384), ("d4", 262144, 192, 384, 96),
]
PEAK_BF16_FLOPS = 989e12


def _short(kernel: str) -> str:
    """``tail_fc1_kernel<false, 64>`` out of the profiler's demangled name."""
    m = re.search(r"(tail_\w+_kernel<[^>]*>)", kernel)
    return m.group(1) if m else kernel


def run() -> dict:
    import torch

    from csts_torch.kernels import block as kb
    from csts_torch.tools.profile_forward import device_ms, device_trace

    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    out = []
    with torch.inference_mode():
        for name, m, c, h, co in SITES:
            x = r(1, m, c)
            w = [1 + r(c, scale=0.1), r(c, scale=0.1), r(h, c, scale=c ** -0.5), r(h, scale=0.1),
                 r(co, h, scale=h ** -0.5), r(co, scale=0.1)]
            w += [r(co, c, scale=c ** -0.5), r(co, scale=0.1)] if c != co else [None, None]
            dp = torch.ones(1, device="cuda")
            row = {"site": name, "rows": m, "C": c, "H": h, "C_out": co}
            for tag, fn in (("k2", lambda: kb.fused_mlp_tail(x, *w)),
                            ("b7", lambda: kb.fused_mlp_tail_train(x, *w, dp))):
                _, busy, by_name, _ = device_trace(fn)
                row[tag] = {"busy_ms": busy, "kernels_ms": by_name}
            x2 = x.reshape(m, c)
            g = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
            row["cublas_ms"] = {"fc1": device_ms(lambda: torch.mm(x2, w[2].t())),
                                "fc2": device_ms(lambda: torch.mm(g, w[4].t()))}
            if w[6] is not None:
                row["cublas_ms"]["proj"] = device_ms(lambda: torch.mm(x2, w[6].t()))
            flops = 2 * m * (c * h + h * co + (c * co if w[6] is not None else 0))
            row["ops_ms_at_peak"] = flops / PEAK_BF16_FLOPS * 1e3
            print(f"{name}: K2 {row['k2']['busy_ms']:.4f} ms busy ("
                  + ", ".join(f"{_short(k)} {v:.4f}" for k, v in row["k2"]["kernels_ms"].items())
                  + f"); B7 {row['b7']['busy_ms']:.4f}; cuBLAS "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row["cublas_ms"].items())
                  + f"; the products at peak {row['ops_ms_at_peak']:.4f}", flush=True)
            out.append(row)
            del x, w, g
    return {"sites": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "tail_phases.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tail_phases: needs a CUDA card", file=sys.stderr)
        return 1
    from csts_torch.tools import card_line

    result = {"card": card_line(), **run()}
    print(result["card"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
