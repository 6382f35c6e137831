"""K1 (attention), B3 (the identity block), B4 (the Q-pool block), B5 (the
decoder block), K2 (the MLP tail), K3 (the T×2 upsample), B7 (the training
MLP tail) and B8 (the attention backward) of two checkouts of the
repository, at the flagship's batch-8 shapes, in turns on one card:

    python csts_torch/tools/ab_kernels.py --roots OLD NEW [--rounds 1] [--out PATH]
    python csts_torch/tools/ab_kernels.py --key-split [--rounds 2] [--out PATH]

Each root is a checkout of the port (for example a ``git archive`` of the
parent commit unpacked under ``build/``); each turn runs in a process of its
own that imports that root's ``csts_torch`` (its kernels build into its own
``build/``) and times it with this checkout's ``mean_ms``, ``device_ms`` and
``device_trace``, so that both roots are read by the same clock and the same
profiler rule. Turns go OLD, NEW, NEW, OLD per
round. A turn times, at every K1 shape of the forward (16 launches), at
B3's three sites (v0, a0, v2), at B4's four sites (v1, a1, v3, a2), at B5's
three sites (d2, d3, d4), at K3's two (d4's skip, the head's stem skip), at K2's
16 sites of the forward, at B7's 26 sites and B8's 25 sites of a training
step, the root's wrapper with CUDA events over
back-to-back calls (host cost included) and by its device time
(``device_ms``: the summed durations of the device activities the calls
launch, ``torch.profiler``), and at K1's shapes
``F.scaled_dot_product_attention`` the same two ways. Inputs are random from
a seed, in bf16; q (and k, v where Lq = Lk) are head views of one fused qkv
tensor, as in the model (B8's g a head view of a token-major gradient, its
out and lse from the root's K1). A root's first turn also builds its
kernels.

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
import importlib.util
import inspect
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
# (name, fine grid, dim, dim_out, heads): B4's sites at batch 8 (Lk 1024, hidden 4·dim)
B4_SITES = [
    ("v1", (4, 64, 64), 192, 192, 2), ("a1", (4, 64, 64), 192, 384, 2),
    ("v3", (4, 32, 32), 384, 384, 4), ("a2", (4, 32, 32), 384, 768, 4),
]
# (name, heads, Lq, Lk, hd, launches a step): B8's 25 unmasked sites of a
# training step at batch 8
B8_SITES = [
    ("v0,a0", 1, 16384, 256, 96, 2), ("v1,a1", 2, 4096, 1024, 96, 2),
    ("v2", 2, 4096, 256, 96, 1), ("v3,a2", 4, 1024, 1024, 96, 2),
    ("v4-v13", 4, 1024, 256, 96, 10), ("v14,a3", 8, 256, 1024, 96, 2),
    ("v15", 8, 256, 256, 96, 1), ("temporal fusion", 8, 8, 8, 96, 1),
    ("d1", 8, 1024, 64, 96, 1), ("d2", 4, 4096, 64, 192, 1), ("d3", 4, 16384, 64, 96, 1),
    ("d4", 2, 32768, 64, 96, 1),
]
# (name, rows a clip, dim, dim_out, heads, launches a forward): B3's sites
# (Lk 256, hidden 4·dim)
B3_SITES = [("v0,a0", 16384, 96, 192, 1, 2), ("v2", 4096, 192, 384, 2, 1)]
# (name, grid, channels): K3's two launches a forward
K3_SITES = [("d4 skip", (4, 64, 64), 192), ("stem skip", (4, 64, 64), 1)]
BATCH, LK_DEC, LK_POOL, LK_BLOCK = 8, 64, 1024, 256
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


def b4_inputs(thw, c, cout, heads, gen):
    """B4's arguments at a site: the fine Q (the Q columns of a fused
    projection), the max-pooled skip on the coarse grid, the pooled K/V and
    the block's weights, bf16."""
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    hd, hidden = c // heads, 4 * c
    l_fine = thw[0] * thw[1] * thw[2]
    l_coarse = thw[0] * ((thw[1] + 1) // 2) * ((thw[2] + 1) // 2)
    proj = [r(cout, c, scale=c ** -0.5), r(cout, scale=0.1)] if c != cout else [None, None]
    return [r(BATCH, l_fine, 3 * c)[..., :c], thw, r(BATCH, l_coarse, c),
            r(BATCH, heads, LK_POOL, hd), r(BATCH, heads, LK_POOL, hd), hd ** -0.5,
            r(hd, 1, 3, 3, 3, scale=0.2), 1 + r(hd, scale=0.1), r(hd, scale=0.1),
            r(c, c, scale=c ** -0.5), r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(hidden, c, scale=c ** -0.5), r(hidden, scale=0.1),
            r(cout, hidden, scale=hidden ** -0.5), r(cout, scale=0.1)] + proj


def b3_inputs(rows, c, cout, heads, gen):
    """B3's arguments at a site but the last: x, the pooled K/V and the
    block's weights (LN1, the Q rows of the fused projection, proj, the
    tail), bf16. The block also passes LN1(x), phase 1's rows."""
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    hd, hidden = c // heads, 4 * c
    proj = [r(cout, c, scale=c ** -0.5), r(cout, scale=0.1)] if c != cout else [None, None]
    x, ln1_w, ln1_b = r(BATCH, rows, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
    return [x, r(BATCH, heads, LK_BLOCK, hd), r(BATCH, heads, LK_BLOCK, hd),
            hd ** -0.5, ln1_w, ln1_b, r(c, c, scale=c ** -0.5),
            r(c, scale=0.1), r(c, c, scale=c ** -0.5), r(c, scale=0.1), 1 + r(c, scale=0.1),
            r(c, scale=0.1), r(hidden, c, scale=c ** -0.5), r(hidden, scale=0.1),
            r(cout, hidden, scale=hidden ** -0.5), r(cout, scale=0.1)] + proj


def b8_inputs(n, lq, lk, hd, gen):
    """B8's arguments at a site: q, k, v, K1's out and lse from them, and g a
    head view of a token-major (B, Lq, N·hd) gradient, bf16."""
    import torch

    from csts_torch.kernels import attention as ka

    q, k, v, scale, _ = k1_inputs(BATCH, n, lq, lk, hd, False, gen)
    out, lse = ka._attention_fwd(q, k, v, scale, None, with_lse=True)
    g = torch.randn(BATCH, lq, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, out, g.permute(0, 2, 1, 3), scale, lse


def tail_inputs(rows, c, h, cout, gen):
    """x (8, rows, C) and the tail's weights (LN2, fc1, fc2, the dim-change
    proj or None), bf16."""
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    proj = [r(cout, c, scale=c ** -0.5), r(cout, scale=0.1)] if c != cout else [None, None]
    return [r(BATCH, rows, c), 1 + r(c, scale=0.1), r(c, scale=0.1), r(h, c, scale=c ** -0.5),
            r(h, scale=0.1), r(cout, h, scale=h ** -0.5), r(cout, scale=0.1)] + proj


def own_timers():
    """``mean_ms``, ``device_ms`` and ``device_trace`` of this checkout,
    loaded from their files (which import nothing of the package), whatever
    root the turn imports."""
    here = os.path.dirname(os.path.abspath(__file__))
    mods = []
    for name, rel in (("ab_timer_tools", "__init__.py"),
                      ("ab_timer_profile", "profile_forward.py")):
        spec = importlib.util.spec_from_file_location(name, os.path.join(here, rel))
        mods.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])
    return mods[0].mean_ms, mods[1].device_ms, mods[1].device_trace


def worker(root: str) -> dict:
    """One turn: the root's kernels at every site (imports the root's package,
    times it with this checkout's timers)."""
    mean_ms, device_ms, device_trace = own_timers()
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    from csts_torch.kernels import _build
    from csts_torch.kernels import attention as ka
    from csts_torch.kernels import block as kb
    from csts_torch.kernels import upsample as kup

    t0 = time.perf_counter()
    _build.build_all()
    out = {"root": root, "build_s": time.perf_counter() - t0, "k1": [], "b3": [], "b4": [],
           "b5": [], "k2": [], "k3": [], "b7": [], "b8": []}
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
        # A root whose B3 computes LN1 in its body (before this port's
        # redesign of B3) takes no xn; a root that takes xn is timed with the
        # LN1 that makes it (phase 1's op) inside each call, so that both
        # sides count LN1
        takes_xn = "xn" in inspect.signature(kb.fused_block).parameters
        for name, rows, c, cout, heads, count in B3_SITES:
            args = b3_inputs(rows, c, cout, heads, gen)
            if takes_xn:
                kern = lambda: kb.fused_block(  # noqa: E731
                    *args, F.layer_norm(args[0], (args[0].shape[-1],), args[4], args[5], 1e-6))
            else:
                kern = lambda: kb.fused_block(*args)  # noqa: E731
            # the device time of each of the launches a call makes (B3's split
            # runs five to six kernels a call), over 10 calls
            by_name = device_trace(lambda: [kern() for _ in range(10)])[2]
            out["b3"].append({"name": name, "launches": count, "ms": mean_ms(kern, dev, 20),
                              "device_ms": device_ms(kern, 10),
                              "kernels_device_ms": {k: v / 10 for k, v in by_name.items()}})
            del args
        for name, thw, c in K3_SITES:
            x = torch.randn(BATCH, thw[0] * thw[1] * thw[2], c, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kern = lambda: kup.t2_upsample(x, thw)  # noqa: E731
            out["k3"].append({"name": name, "launches": 1, "ms": mean_ms(kern, dev, 50),
                              "device_ms": device_ms(kern)})
            del x
        for name, thw, c, cout, heads in B4_SITES:
            args = b4_inputs(thw, c, cout, heads, gen)
            kern = lambda: kb.fused_pool_block(*args)  # noqa: E731
            out["b4"].append({"name": name, "ms": mean_ms(kern, dev, 20),
                              "device_ms": device_ms(kern, 10)})
            del args
        for name, n, lq, lk, hd, count in B8_SITES:
            args = b8_inputs(n, lq, lk, hd, gen)
            kern = lambda: ka.fused_attention_bwd(*args)  # noqa: E731
            out["b8"].append({"name": name, "launches": count, "ms": mean_ms(kern, dev, 20),
                              "device_ms": device_ms(kern, 10)})
            del args
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
                if key == "k2":  # each of K2's three kernels (LN2, fc1, fc2), over 10 calls
                    by_name = device_trace(lambda: [kern() for _ in range(10)])[2]
                    out[key][-1]["kernels_device_ms"] = {k: v / 10 for k, v in by_name.items()}
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
            b4 = {site[0]: {key: med([t["b4"][i][key] for t in ts]) for key in ("ms", "device_ms")}
                  for i, site in enumerate(B4_SITES)}
            b8_sites = {site[0]: {key: med([t["b8"][i][key] for t in ts])
                                  for key in ("ms", "device_ms")}
                        for i, site in enumerate(B8_SITES)}
            b8 = {"sites": b8_sites, **{key: sum(b8_sites[site[0]][key] * site[5]
                                                 for site in B8_SITES)
                                        for key in ("ms", "device_ms")}}
            tails = {}
            for part, sites in (("k2", K2_SITES), ("b7", B7_SITES), ("b3", B3_SITES),
                                ("k3", [(name, thw, c, None, None, 1)
                                        for name, thw, c in K3_SITES])):
                per_site = {site[0]: {key: med([t[part][i][key] for t in ts])
                                      for key in ("ms", "device_ms")}
                            for i, site in enumerate(sites)}
                tails[part] = {"sites": per_site,
                               **{key: sum(per_site[site[0]][key] * site[5] for site in sites)
                                  for key in ("ms", "device_ms")}}
            summary[root] = {"k1_forward": k1, "b3_forward": tails["b3"], "b4": b4, "b5": b5,
                             "k2_forward": tails["k2"], "k3_forward": tails["k3"],
                             "b7_step": tails["b7"], "b8_step": b8,
                             "k1_shapes": [{key: (med([t["k1"][i][key] for t in ts])
                                                  if key != "name" else ts[0]["k1"][i]["name"])
                                            for key in ts[0]["k1"][i] if key != "launches"}
                                           for i in range(len(K1_SHAPES))]}
            print(f"{root}: K1 a forward {k1['ms']:.4f} ms events, {k1['device_ms']:.4f} ms "
                  f"device (SDPA {k1['library_ms']:.4f} / {k1['library_device_ms']:.4f}); B5 "
                  + ", ".join(f"{s} {v['ms']:.4f}/{v['device_ms']:.4f}" for s, v in b5.items())
                  + " ms events/device; K2 a forward {:.4f} / {:.4f}, B7 a step {:.4f} / "
                  "{:.4f} ms events/device".format(tails["k2"]["ms"], tails["k2"]["device_ms"],
                                                   tails["b7"]["ms"], tails["b7"]["device_ms"])
                  + "; B4 " + ", ".join(f"{s} {v['ms']:.4f}/{v['device_ms']:.4f}"
                                        for s, v in b4.items())
                  + f" (sum {sum(v['device_ms'] for v in b4.values()):.4f} device); B8 a step "
                  f"{b8['ms']:.4f} / {b8['device_ms']:.4f} ms events/device; B3 a forward "
                  + "{:.4f} / {:.4f} (".format(tails["b3"]["ms"], tails["b3"]["device_ms"])
                  + ", ".join(f"{s} {v['device_ms']:.4f}" for s, v in tails["b3"]["sites"].items())
                  + " device); K3 a forward {:.4f} / {:.4f} ms events/device".format(
                      tails["k3"]["ms"], tails["k3"]["device_ms"]))
        result = {"card": card, "summary": summary, "turns": turns}
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
