"""Export weights as a serving artifact (``torch.export``), the counterpart
of the JAX package's ``tools/export_serving.py``:

    python -m csts_torch.tools.export_serving --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        --checkpoint weights.npz [--use-ema] --out /srv/csts_artifact \\
        [--batch-sizes 1 8] [--device cuda] [KEY VALUE ...]

The directory holds one program per bucket (``forward_b{b}.pt2``, the
kernels as the custom ops of ``csts_torch.kernels``), the weights once
(``params.pt``) and ``meta.json``. A program runs on the device it was
exported on (CUDA by default; ``--device cpu`` for a CPU artifact).
``csts_torch.serving.GazePredictor.from_exported`` reloads it without model
or config code.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--checkpoint", default=None, help=".npz or .pyth (default: seeded init)")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--out", required=True, help="the artifact directory to write")
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    from csts_torch.config import load_config
    from csts_torch.serving import GazePredictor

    cfg = load_config(args.cfg, args.opts or None)
    predictor = GazePredictor.from_checkpoint(cfg, args.checkpoint, use_ema=args.use_ema,
                                              batch_sizes=tuple(args.batch_sizes),
                                              device=args.device)
    t0 = time.perf_counter()
    predictor.export_compiled(args.out)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"wrote {sorted(os.listdir(args.out))} to {args.out}: {size / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
