"""In-process A/B of the whole-block kernel against the K1+K2 route, on
stacks of identical identity-skip blocks at the flagship's stage shapes.

Counterpart of the JAX package's ``tools/ab_block.py``:

    python -m csts_torch.tools.ab_block [--batch 8] [--iters 20] [--rounds 2]

Each stack runs through two routes in one process, timed in turns with CUDA
events (each route's time is the median of its turns):

  composite  ``MultiScaleBlock.forward_composite``: LN1, the qkv projection
             and pooling convs, K1 attention, proj, the skip, K2 MLP tail
  block      ``MultiScaleBlock.forward_block``: LN1 and the pooled K/V
             (phase 1), then ``kb.fused_block`` — B3 at 1-2 heads, and at
             3-8 heads the kernel that stands for the JAX package's
             head-grid and block-diagonal variants (B9b/B9c), which the
             eval dispatch (``block_route``) does not reach

Weights are random from a seeded ``torch.Generator`` (the model's init
rules), in bf16, as are the inputs. A numerical guard prints the block
route's max|Δ| against the composite's. Each shape gives one line with both
times and the ratio, and on the card each route's device busy time for one
call (``torch.profiler``), which does not depend on how fast the host
launches; then the card's name and power limit. It runs on CUDA
unless ``--device cpu`` is given; ``--small`` takes narrow shapes (for a
check on the CPU, where the kernels' plain twins run and the host clock
gives no device metric).
"""

from __future__ import annotations

import argparse
import statistics
from typing import List, Sequence, Tuple

import torch

from csts_torch.models.mvit import AttentionSpec, MultiScaleBlock

# (name, dim, dim_out, heads, thw, stride_kv, reps): the JAX tool's four
# rows (tools/ab_block.py:36-41), and the 384 -> 768 widening of
# tests/test_fused_block.py:24 at stage 2's grid (the flagship's v13)
SHAPES = [
    ("stem b0    L=16384 h=1 d=96    ", 96, 96, 1, (4, 64, 64), (1, 8, 8), 1),
    ("stage1 b2  L=4096  h=2 d=192   ", 192, 192, 2, (4, 32, 32), (1, 4, 4), 1),
    ("stage2     L=1024  h=4 d=384   ", 384, 384, 4, (4, 16, 16), (1, 2, 2), 10),
    ("stage3 b15 L=256   h=8 d=768   ", 768, 768, 8, (4, 8, 8), (1, 1, 1), 2),
    ("widen b13  L=1024  h=4 384>768 ", 384, 768, 4, (4, 16, 16), (1, 2, 2), 1),
]
# the same head counts at narrow widths and small grids
SMALL = [
    ("small h=1 d=32 ", 32, 32, 1, (2, 8, 8), (1, 4, 4), 1),
    ("small h=2 d=32 ", 32, 32, 2, (2, 8, 8), (1, 2, 2), 1),
    ("small h=4 d=64 ", 64, 64, 4, (2, 4, 4), (1, 2, 2), 3),
    ("small h=8 d=128", 128, 128, 8, (1, 4, 4), (1, 1, 1), 2),
    ("small h=4 64>128", 64, 128, 4, (2, 4, 4), (1, 2, 2), 1),
]
Row = Tuple[str, int, int, int, Tuple[int, int, int], Tuple[int, int, int], int]


def make_stack(row: Row, batch: int, device, seed: int = 0):
    """The block of one row (bf16, eval) and its input x (B, L, dim)."""
    from csts_torch.models.csts import init_params

    _, dim, dim_out, heads, thw, stride_kv, _ = row
    spec = AttentionSpec(dim=dim, dim_out=dim_out, num_heads=heads, kernel_q=(),
                         kernel_kv=(3, 3, 3), stride_q=(), stride_kv=stride_kv)
    block = MultiScaleBlock(spec)
    init_params(block, torch.Generator().manual_seed(seed))
    block = block.to(torch.bfloat16).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(batch, thw[0] * thw[1] * thw[2], dim, generator=gen, device=device)
    return block, x.to(torch.bfloat16)


def stack_fns(block: MultiScaleBlock, thw, reps: int):
    """(composite, block): ``reps`` applications of the block through each
    route (a widening block applies once)."""
    def run(route):
        def fn(x):
            with torch.inference_mode():
                for _ in range(reps):
                    x = route(x, thw)[0]
            return x
        return fn
    return run(block.forward_composite), run(block.forward_block)


def run(rows: Sequence[Row], batch: int, iters: int, device, log=print,
        rounds: int = 2) -> List[dict]:
    """Both routes of every row, timed in turns (composite, block, block,
    composite, ``rounds`` times), each turn the mean over ``iters`` calls;
    ms is the median of a route's turns."""
    from csts_torch.tools import device_name, mean_ms
    from csts_torch.tools.profile_forward import device_trace

    device = torch.device(device)
    out = []
    for row in rows:
        name, dim, dim_out, heads, thw, _, reps = row
        block, x = make_stack(row, batch, device)
        composite, fused = stack_fns(block, thw, reps if dim == dim_out else 1)
        delta = float((fused(x).float() - composite(x).float()).abs().max())
        turns = {"composite": [], "block": []}
        for route in ("composite", "block", "block", "composite") * rounds:
            fn = composite if route == "composite" else fused
            turns[route].append(mean_ms(lambda: fn(x), device, iters))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        # the device's busy time of one call of each route (torch.profiler),
        # which the host's launch rate does not enter
        busy = {k: (device_trace(lambda: fn(x))[1] if device.type == "cuda" else None)
                for k, fn in (("composite", composite), ("block", fused))}
        res = {"name": name.strip(), "dim": dim, "dim_out": dim_out, "heads": heads,
               "thw": list(thw), "reps": reps if dim == dim_out else 1, "batch": batch,
               "composite_ms": ms["composite"], "block_ms": ms["block"],
               "composite_turns_ms": turns["composite"], "block_turns_ms": turns["block"],
               "composite_device_ms": busy["composite"], "block_device_ms": busy["block"],
               "max_abs_diff": delta, "device": device_name(device)}
        out.append(res)
        line = (f"{name} reps={res['reps']:2d}: composite={ms['composite']:8.3f}ms  "
                f"block={ms['block']:8.3f}ms ({ms['composite'] / ms['block']:4.2f}x)")
        if busy["block"]:
            line += (f"  device busy composite={busy['composite']:8.3f}ms "
                     f"block={busy['block']:8.3f}ms ({busy['composite'] / busy['block']:4.2f}x)")
        log(line + f"  max|Δ| block vs composite {delta:.3g}")
        del block, x
    return out


def main(argv=None) -> int:
    from csts_torch import resolve_device
    from csts_torch.tools import card_line, device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2, help="turns over the two routes")
    ap.add_argument("--small", action="store_true", help="narrow shapes (CPU check)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    clock = "CUDA events" if device.type == "cuda" else "host clock, no device metric"
    print(f"device: {device_name(device)}  batch={args.batch} iters={args.iters} "
          f"rounds={args.rounds} ({clock})")
    run(SMALL if args.small else SHAPES, args.batch, args.iters, device, rounds=args.rounds)
    if device.type == "cuda":
        print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
