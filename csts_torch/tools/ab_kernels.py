"""K1 (attention), B5 (the decoder block), K2 (the MLP tail) and B7 (the
training MLP tail) of two checkouts of the repository, at the flagship's
batch-8 shapes, in turns on one card:

    python csts_torch/tools/ab_kernels.py --roots OLD NEW [--rounds 1] [--out PATH]
    python csts_torch/tools/ab_kernels.py --key-split [--rounds 2] [--out PATH]

Each root is a checkout whose ``profile_forward`` has ``device_ms`` (for
example a ``git archive`` of the parent commit unpacked under ``build/``); each turn
runs in a process of its own that imports that root's ``csts_torch`` (its
kernels build into its own ``build/``). Turns go OLD, NEW, NEW, OLD per
round. A turn times, at every K1 shape of the forward (16 launches), at
B5's three sites (d2, d3, d4), at K2's 16 sites of the forward and at B7's
26 sites of a training step, the root's wrapper with CUDA events over
back-to-back calls (host cost included) and by its device time
(``device_ms``: the summed durations of the device activities the calls
launch, ``torch.profiler``), and at K1's shapes
``F.scaled_dot_product_attention`` the same two ways. Inputs are random from
a seed, in bf16; q (and k, v where Lq = Lk) are head views of one fused qkv
tensor, as in the model. A root's first turn also builds its kernels.

``--key-split`` instead holds K1's key-split policy (``key_splits``) against
no split in this checkout, at the batches where the policy splits (1, 2, 4;
``GazePredictor``'s one-clip bucket among them): K1 at the Q-pool shape (v14,
a3) and the flagship's bf16 forward, each by device time and by CUDA events,
in turns (policy, none, none, policy) per round.

The result (medians over the turns, and every turn) goes to ``--out``; the
card's name and power limit are printed beside it. It needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# (name, batch, heads, Lq, Lk, hd, masked, launches a forward): K1's sites
K1_SHAPES = [
    ("v4-v13", 8, 4, 1024, 256, 96, False, 10),
    ("v14,a3", 8, 8, 256, 1024, 96, False, 2),
    ("v15", 8, 8, 256, 256, 96, False, 1),
    ("spatial fusion", 8, 8, 260, 260, 96, True, 1),
    ("temporal fusion", 8, 8, 8, 8, 96, False, 1),
    ("d1", 8, 8, 1024, 64, 96, False, 1),
]
# (name, coarse grid, stride, dim, dim_out, heads): B5's sites at batch 8
B5_SITES = [
    ("d2", (4, 16, 16), (1, 2, 2), 768, 384, 4),
    ("d3", (4, 32, 32), (1, 2, 2), 384, 192, 4),
    ("d4", (4, 64, 64), (2, 1, 1), 192, 96, 2),
]
# (name, rows a clip, C, H, C_out, launches): K2's sites in a forward
K2_SITES = [
    ("v4-v12", 1024, 384, 1536, 384, 9), ("v13", 1024, 384, 1536, 768, 1),
    ("v14,v15,a3", 256, 768, 3072, 768, 3), ("spatial fusion", 260, 768, 3072, 768, 1),
    ("temporal fusion", 8, 768, 3072, 768, 1), ("d1", 1024, 768, 3072, 768, 1),
]
# B7's sites in a training step: every block's tail
B7_SITES = [
    ("v0,a0", 16384, 96, 384, 192, 2), ("v1", 4096, 192, 768, 192, 1),
    ("v2,a1", 4096, 192, 768, 384, 2), ("v3-v12", 1024, 384, 1536, 384, 10),
    ("v13,a2", 1024, 384, 1536, 768, 2), ("v14,v15,a3", 256, 768, 3072, 768, 3),
    ("spatial fusion", 260, 768, 3072, 768, 1), ("temporal fusion", 8, 768, 3072, 768, 1),
    ("d1", 1024, 768, 3072, 768, 1), ("d2", 4096, 768, 1536, 384, 1),
    ("d3", 16384, 384, 768, 192, 1), ("d4", 32768, 192, 384, 96, 1),
]
BATCH, LK_DEC = 8, 64
SPLIT_BATCHES = (1, 2, 4)
# a profile that saw no device activity (torch.profiler now and then returns
# none) reads 0.0: it is no reading and stays out of the median
med = lambda xs: statistics.median([x for x in xs if x] or [0.0])  # noqa: E731


def k1_inputs(b, n, lq, lk, hd, masked, gen):
    import torch

    qkv = torch.randn(b, lq, 3, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
    q = qkv[:, :, 0].permute(0, 2, 1, 3)
    if lq == lk:
        k, v = qkv[:, :, 1].permute(0, 2, 1, 3), qkv[:, :, 2].permute(0, 2, 1, 3)
    else:
        k, v = (torch.randn(b, n, lk, hd, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
    mask = None
    if masked:  # the spatial fusion's in-frame mask, as the bf16 model holds it
        from csts_torch.models.mvit import build_inframe_mask

        mask = torch.from_numpy(build_inframe_mask((4, 8, 8), 4)).cuda().to(torch.bfloat16)
    return q, k, v, hd ** -0.5, mask


def b5_inputs(thw, stride, c, cout, heads, gen):
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    hd, hidden = c // heads, 4 * cout
    l_src = thw[0] * thw[1] * thw[2]
    l_out = l_src * stride[0] * stride[1] * stride[2]
    q = r(BATCH, l_src, 3 * c)[..., :c]  # the Q columns of the fused projection
    return [q, thw, stride, r(BATCH, l_out, c), r(BATCH, heads, LK_DEC, hd),
            r(BATCH, heads, LK_DEC, hd), hd ** -0.5, r(hd, 1, 3, 3, 3, scale=0.2),
            1 + r(hd, scale=0.1), r(hd, scale=0.1), r(c, c, scale=c ** -0.5), r(c, scale=0.1),
            1 + r(c, scale=0.1), r(c, scale=0.1), r(hidden, c, scale=c ** -0.5),
            r(hidden, scale=0.1), r(cout, hidden, scale=hidden ** -0.5), r(cout, scale=0.1),
            r(cout, c, scale=c ** -0.5), r(cout, scale=0.1)]


def tail_inputs(rows, c, h, cout, gen):
    """x (8, rows, C) and the tail's weights (LN2, fc1, fc2, the dim-change
    proj or None), bf16."""
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    proj = [r(cout, c, scale=c ** -0.5), r(cout, scale=0.1)] if c != cout else [None, None]
    return [r(BATCH, rows, c), 1 + r(c, scale=0.1), r(c, scale=0.1), r(h, c, scale=c ** -0.5),
            r(h, scale=0.1), r(cout, h, scale=h ** -0.5), r(cout, scale=0.1)] + proj


def worker(root: str) -> dict:
    """One turn: the root's K1 and B5 at every shape (imports the root's package)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    from csts_torch.kernels import _build
    from csts_torch.kernels import attention as ka
    from csts_torch.kernels import block as kb
    from csts_torch.tools import mean_ms
    from csts_torch.tools.profile_forward import device_ms

    t0 = time.perf_counter()
    _build.build_all()
    out = {"root": root, "build_s": time.perf_counter() - t0, "k1": [], "b5": [], "k2": [],
           "b7": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    with torch.inference_mode():
        for name, b, n, lq, lk, hd, masked, count in K1_SHAPES:
            q, k, v, scale, mask = k1_inputs(b, n, lq, lk, hd, masked, gen)
            kern = lambda: ka.fused_attention(q, k, v, scale, mask)  # noqa: E731
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, scale=scale)
            out["k1"].append({"name": name, "launches": count, "ms": mean_ms(kern, dev, 50),
                              "device_ms": device_ms(kern), "library_ms": mean_ms(lib, dev, 50),
                              "library_device_ms": device_ms(lib)})
        for name, thw, stride, c, cout, heads in B5_SITES:
            args = b5_inputs(thw, stride, c, cout, heads, gen)
            kern = lambda: kb.fused_decoder_block(*args)  # noqa: E731
            out["b5"].append({"name": name, "ms": mean_ms(kern, dev, 20),
                              "device_ms": device_ms(kern, 10)})
            del args
        dp = torch.ones(BATCH, device=dev)
        for key, sites in (("k2", K2_SITES), ("b7", B7_SITES)):
            for name, rows, c, h, cout, count in sites:
                args = tail_inputs(rows, c, h, cout, gen)
                kern = ((lambda: kb.fused_mlp_tail(*args)) if key == "k2"  # noqa: E731
                        else (lambda: kb.fused_mlp_tail_train(*args, dp)))
                out[key].append({"name": name, "launches": count, "ms": mean_ms(kern, dev, 20),
                                 "device_ms": device_ms(kern, 10)})
                del args
    return out


@contextlib.contextmanager
def no_key_split():
    """K1's wrapper with its key-split policy set to one split."""
    from csts_torch.kernels import attention as ka

    policy = ka.key_splits
    ka.key_splits = lambda *_: 1
    try:
        yield
    finally:
        ka.key_splits = policy


def key_split_ab(rounds: int) -> dict:
    """K1 at the Q-pool shape and the flagship bf16 forward at
    ``SPLIT_BATCHES``: the key-split policy against none, in turns."""
    import torch

    from csts_torch.kernels import attention as ka
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import flagship_cfg
    from csts_torch.tools import mean_ms
    from csts_torch.tools.profile_forward import device_ms, device_trace
    from csts_torch.train.losses import frame_softmax

    dev = torch.device("cuda")
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, n, lq, lk, hd, _, _ = K1_SHAPES[1]
    out = {}
    for b in SPLIT_BATCHES:
        q, k, v, scale, _ = k1_inputs(b, n, lq, lk, hd, False, gen)
        t = spec.num_frames
        video = torch.randn(b, t, spec.crop_size, spec.crop_size, 3, generator=gen, device=dev)
        audio = torch.randn(b, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1,
                            generator=gen, device=dev)
        k1 = lambda: ka.fused_attention(q, k, v, scale)  # noqa: E731
        fwd = lambda: frame_softmax(model(video, audio), temperature=2.0)  # noqa: E731
        turns = {"policy": [], "none": []}
        with torch.inference_mode():
            for _ in range(rounds):
                for mode in ("policy", "none", "none", "policy"):
                    with no_key_split() if mode == "none" else contextlib.nullcontext():
                        turns[mode].append({
                            "k1_ms": mean_ms(k1, dev, 50), "k1_device_ms": device_ms(k1),
                            "forward_ms": mean_ms(fwd, dev, 10),
                            "forward_device_busy_ms": device_trace(fwd)[1]})
        row = {"splits": ka.key_splits(b * n, lq, lk, sms), "turns": turns}
        for mode, ts in turns.items():
            row[mode] = {key: med([x[key] for x in ts]) for key in ts[0]}
        out[b] = row
        print(f"batch {b}: K1 v14/a3 with {row['splits']} splits "
              f"{row['policy']['k1_device_ms']:.4f} ms device / {row['policy']['k1_ms']:.4f} "
              f"events, none {row['none']['k1_device_ms']:.4f} / {row['none']['k1_ms']:.4f}; "
              f"forward {row['policy']['forward_device_busy_ms']:.3f} ms busy / "
              f"{row['policy']['forward_ms']:.3f} events, none "
              f"{row['none']['forward_device_busy_ms']:.3f} / {row['none']['forward_ms']:.3f}")
        del q, k, v, video, audio
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("OLD", "NEW"), required=False)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab_kernels.json"))
    ap.add_argument("--key-split", action="store_true",
                    help="K1's key-split policy against none in this checkout")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if args.key_split:
        # this checkout's package (a script's own directory heads sys.path)
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        result = {"card": card, "key_split": key_split_ab(args.rounds)}
    else:
        roots = args.roots or [".", "."]
        turns = {r: [] for r in roots}
        for _ in range(args.rounds):
            for root in (roots[0], roots[1], roots[1], roots[0]):
                res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"turn on {root} failed:\n{res.stdout[-4000:]}\n"
                                       f"{res.stderr[-8000:]}")
                turns[root].append(json.loads(res.stdout.strip().splitlines()[-1]))
        summary = {}
        for root, ts in turns.items():
            k1 = {key: sum(med([t["k1"][i][key] for t in ts]) * ts[0]["k1"][i]["launches"]
                           for i in range(len(K1_SHAPES)))
                  for key in ("ms", "device_ms", "library_ms", "library_device_ms")}
            b5 = {site[0]: {key: med([t["b5"][i][key] for t in ts]) for key in ("ms", "device_ms")}
                  for i, site in enumerate(B5_SITES)}
            tails = {}
            for part, sites in (("k2", K2_SITES), ("b7", B7_SITES)):
                per_site = {site[0]: {key: med([t[part][i][key] for t in ts])
                                      for key in ("ms", "device_ms")}
                            for i, site in enumerate(sites)}
                tails[part] = {"sites": per_site,
                               **{key: sum(per_site[site[0]][key] * site[5] for site in sites)
                                  for key in ("ms", "device_ms")}}
            summary[root] = {"k1_forward": k1, "b5": b5, "k2_forward": tails["k2"],
                             "b7_step": tails["b7"],
                             "k1_shapes": [{key: (med([t["k1"][i][key] for t in ts])
                                                  if key != "name" else ts[0]["k1"][i]["name"])
                                            for key in ts[0]["k1"][i] if key != "launches"}
                                           for i in range(len(K1_SHAPES))]}
            print(f"{root}: K1 a forward {k1['ms']:.4f} ms events, {k1['device_ms']:.4f} ms "
                  f"device (SDPA {k1['library_ms']:.4f} / {k1['library_device_ms']:.4f}); B5 "
                  + ", ".join(f"{s} {v['ms']:.4f}/{v['device_ms']:.4f}" for s, v in b5.items())
                  + " ms events/device; K2 a forward {:.4f} / {:.4f}, B7 a step {:.4f} / "
                  "{:.4f} ms events/device".format(tails["k2"]["ms"], tails["k2"]["device_ms"],
                                                   tails["b7"]["ms"], tails["b7"]["device_ms"]))
        result = {"card": card, "summary": summary, "turns": turns}
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
