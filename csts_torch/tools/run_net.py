"""Command-line entry point, the counterpart of the JAX package's
``tools/run_net.py`` (reference ``tools/run_net.py:11-25`` +
``utils/parser.py:13-94``):

    python -m csts_torch.tools.run_net --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        DATA.PATH_PREFIX /data/Ego4D/clips.gaze OUTPUT_DIR runs/forecast [KEY VALUE ...]

The same flags and the same config loading (the port's own YAML reader, no
PyYAML). TRAIN.ENABLE runs ``csts_torch.train.trainer.train`` (auto-resume
from OUTPUT_DIR, fine-tune init from TRAIN.CHECKPOINT_FILE_PATH), then
TEST.ENABLE runs ``csts_torch.eval.tester.test``, which scores the newest
checkpoint the trainer wrote unless TEST.CHECKPOINT_FILE_PATH names
another. It runs on CUDA unless ``--device`` names another device, and
raises with no CUDA. Several shards (ROADMAP A.8) raise.
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
    """Trains, then tests, as the config enables; returns the test stats
    (empty if TEST.ENABLE is off)."""
    from csts_torch.config import load_config

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file, args.opts or None)
    cfg.NUM_SHARDS = args.num_shards
    cfg.SHARD_ID = args.shard_id
    if args.num_shards > 1:
        raise NotImplementedError("several shards are not ported yet (ROADMAP A.8)")
    if cfg.TRAIN.ENABLE:
        from csts_torch.train.trainer import train

        train(cfg, device)
    if cfg.TEST.ENABLE:
        from csts_torch.eval.tester import test

        return test(cfg, device)
    return {}


if __name__ == "__main__":
    main()
