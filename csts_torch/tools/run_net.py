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
raises with no CUDA.

Several processes: ``NUM_DEVICES`` ranks a shard (one a card, spawned
here; the CPU with ``--device cpu``, over gloo) times ``--num-shards``
shards, each started with its ``--shard-id`` and the same ``--init-method
tcp://host:port`` (one shard's ranks meet through a ``file://`` store in a
temporary directory unless one is given):

    python -m csts_torch.tools.run_net --cfg X.yaml --num-shards 2 --shard-id 0 \\
        --init-method tcp://10.0.0.1:29500 NUM_DEVICES 8 ...

SOLVER.BASE_LR_SCALE_NUM_SHARDS scales the LRs by ``--num-shards``
(``config.finalize``). A rank that fails ends the run non-zero. No rank,
and no loader worker (``GazeLoader.close``), outlives the call.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Optional, Sequence

import torch

from csts_torch import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="CSTS (PyTorch) train/test runner")
    parser.add_argument("--cfg", dest="cfg_file", type=str, required=True)
    parser.add_argument(
        "--init-method", "--init_method", dest="init_method", type=str, default=None,
        help="the group's rendezvous, tcp://host:port (required with several shards)",
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


def _run(cfg, device) -> dict:
    if cfg.TRAIN.ENABLE:
        from csts_torch.train.trainer import train

        train(cfg, device)
    if cfg.TEST.ENABLE:
        from csts_torch.eval.tester import test

        return test(cfg, device)
    return {}


def _rank_main(local_rank: int, cfg, device, init_method: Optional[str]) -> dict:
    """One rank: joins the group, runs, leaves it."""
    import torch.distributed as dist

    from csts_torch.parallel import mesh

    device = mesh.init_from_cfg(cfg, device, local_rank, init_method)
    try:
        return _run(cfg, device)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Trains, then tests, as the config enables; returns the test stats
    (empty if TEST.ENABLE is off, and in the parent of spawned ranks)."""
    from csts_torch.config import load_config
    from csts_torch.parallel import mesh

    args = parse_args(argv)
    device = resolve_device(args.device)
    # the shard count goes in before finalize, which scales the LRs by it
    opts = list(args.opts or []) + ["NUM_SHARDS", str(args.num_shards),
                                    "SHARD_ID", str(args.shard_id)]
    cfg = load_config(args.cfg_file, opts)
    mesh.check_axes(cfg)
    local = cfg.NUM_DEVICES
    if cfg.NUM_SHARDS * local == 1:
        return _run(cfg, device)
    if device.type == "cuda" and local > torch.cuda.device_count():
        raise RuntimeError(f"NUM_DEVICES {local} ranks a shard, {torch.cuda.device_count()} "
                           "cards visible")
    if local == 1:
        return _rank_main(0, cfg, device, args.init_method)
    meet = (mesh.rendezvous() if args.init_method is None and cfg.NUM_SHARDS == 1
            else contextlib.nullcontext(args.init_method))
    with meet as init_method:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(cfg, device, init_method), nprocs=local, join=False,
            start_method="spawn")
        try:
            while not ctx.join():  # raises when a rank fails, after stopping the others
                pass
        finally:  # this process raised or was interrupted: no rank outlives it
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    return {}


if __name__ == "__main__":
    main()
