"""Command-line entry point, the counterpart of the JAX package's
``tools/run_net.py`` (reference ``tools/run_net.py:11-25`` +
``utils/parser.py:13-94``):

    python -m csts_torch.tools.run_net --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        TRAIN.ENABLE False TEST.CHECKPOINT_FILE_PATH weights.pyth [KEY VALUE ...]

The same flags and the same config loading (a YAML needs PyYAML); TEST.ENABLE
runs ``csts_torch.eval.tester.test``. It runs on CUDA unless ``--device``
names another device, and raises with no CUDA. Training (TRAIN.ENABLE, the
reference's default) is not ported yet (ROADMAP A.6) and raises, as do
several shards (ROADMAP A.8).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from csts_torch import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="CSTS (PyTorch) train/test runner")
    parser.add_argument("--cfg", dest="cfg_file", type=str, required=True)
    parser.add_argument(
        "--init-method", "--init_method", dest="init_method", type=str, default=None,
        help="coordinator address host:port (several shards only)",
    )
    parser.add_argument("--shard-id", "--shard_id", dest="shard_id", type=int, default=0)
    parser.add_argument("--num-shards", "--num_shards", dest="num_shards", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, an error without it)")
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER,
        help="config overrides as KEY VALUE pairs",
    )
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs what the config enables; returns the test stats (empty if
    TEST.ENABLE is off)."""
    from csts_torch.config import load_config

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file, args.opts or None)
    cfg.NUM_SHARDS = args.num_shards
    cfg.SHARD_ID = args.shard_id
    if args.num_shards > 1:
        raise NotImplementedError("several shards are not ported yet (ROADMAP A.8)")
    if cfg.TRAIN.ENABLE:
        raise NotImplementedError(
            "training is not ported yet (ROADMAP A.6); pass TRAIN.ENABLE False to test")
    if cfg.TEST.ENABLE:
        from csts_torch.eval.tester import test

        return test(cfg, device)
    return {}


if __name__ == "__main__":
    main()
