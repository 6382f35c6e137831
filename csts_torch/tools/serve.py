"""Serve gaze inference over HTTP with micro-batching, the counterpart of
the JAX package's ``tools/serve.py``:

    # live weights: an npz TrainState (either package's) or a .pyth
    python -m csts_torch.tools.serve --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        --checkpoint weights.npz [--use-ema] --port 8000 --buckets 1 8 32 [KEY VALUE ...]

    # an export_serving artifact (no model or config code)
    python -m csts_torch.tools.serve --exported /path/to/artifact --port 8000

The protocol is ``csts_torch/serving_server.py``'s: ``POST /predict`` with
an .npz body {video (T,crop,crop,3) float32 normalized or (T,H,W,3) uint8
frames, audio (T,F,S,1) float32} returns an .npz {heatmaps (T,h,w),
gaze_xy (T,2)}; ``GET /healthz``; ``GET /stats``. It runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg", help="YAML config (live weights)")
    parser.add_argument("--checkpoint", help=".npz or .pyth weights (default: seeded init)")
    parser.add_argument("--use-ema", action="store_true",
                        help="serve the EMA weights of an SOLVER.EMA_DECAY run's npz")
    parser.add_argument("--exported", help="an export_serving artifact directory")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", type=int, nargs="+", default=[1, 8],
                        help="static batch buckets (live weights)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="the micro-batching window")
    parser.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE config overrides (live weights)")
    args = parser.parse_args(argv)

    from csts_torch.serving import GazePredictor
    from csts_torch.serving_server import GazeHTTPServer

    if args.exported:
        predictor = GazePredictor.from_exported(args.exported, device=args.device)
    else:
        if not args.cfg:
            parser.error("--cfg is required unless --exported is given")
        from csts_torch.config import load_config

        cfg = load_config(args.cfg, args.opts or None)
        predictor = GazePredictor.from_checkpoint(
            cfg, args.checkpoint, use_ema=args.use_ema, batch_sizes=tuple(args.buckets),
            device=args.device)
    server = GazeHTTPServer(predictor, host=args.host, port=args.port,
                            max_wait_ms=args.max_wait_ms).start()
    print(f"serving on http://{args.host}:{server.port} (buckets {predictor.batch_sizes}, "
          f"max_wait_ms {args.max_wait_ms}, {predictor.device})", flush=True)
    try:
        while True:
            time.sleep(60)
            print(f"stats: {server.batcher.stats()}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
