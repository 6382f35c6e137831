"""Checkpoint reading for evaluation (``csts_tpu/utils/checkpoint.py``; reference
``slowfast/utils/checkpoint.py:579-614``).

The port reads state dicts under the reference's module names: a reference
``.pyth`` (its ``model_state``) or a ``torch.save``d state dict. The JAX
package's ``.npz`` TrainState archives, partial loads and pos-embed
interpolation are not ported yet (ROADMAP A.5) and raise.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch
import torch.nn as nn

from csts_torch.utils.logging import get_logger

logger = get_logger(__name__)

CHECKPOINT_DIR = "checkpoints"
# the JAX package's epoch files (checkpoint.py:36-46), newest last in a lexical sort
_NAME_RE = re.compile(r"checkpoint_epoch_(\d+)(?:_iter_(\d+))?\.npz$")


def checkpoint_dir(output_dir: str) -> str:
    return os.path.join(output_dir, CHECKPOINT_DIR)


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if _NAME_RE.search(n)]
    return os.path.join(d, sorted(names)[-1]) if names else None


def has_checkpoint(output_dir: str) -> bool:
    return get_last_checkpoint(output_dir) is not None


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a reference ``.pyth`` (its ``model_state``) or a
    ``torch.save``d dict of tensors, on the CPU."""
    if path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: the JAX package's .npz checkpoints are not read by the port yet "
            "(ROADMAP A.5); convert the params with csts_torch.convert.from_jax")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["model_state"] if "model_state" in blob else blob


def resolve_test_checkpoint(cfg) -> Optional[str]:
    """TEST.CHECKPOINT_FILE_PATH, else the latest checkpoint in OUTPUT_DIR,
    else TRAIN.CHECKPOINT_FILE_PATH, else None (checkpoint.py:579-614)."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        return cfg.TEST.CHECKPOINT_FILE_PATH
    if has_checkpoint(cfg.OUTPUT_DIR):
        return get_last_checkpoint(cfg.OUTPUT_DIR)
    return cfg.TRAIN.CHECKPOINT_FILE_PATH or None


def load_test_checkpoint(cfg, model: nn.Module) -> Optional[str]:
    """Loads the test checkpoint chain's first source into ``model``
    (``strict=True``) and returns its path; with no source it logs the
    random initialisation, which is the caller's, and returns None. A state dict
    carries no EMA weights: with TEST.USE_EMA the raw weights are scored,
    with a warning, whichever source the chain picked."""
    path = resolve_test_checkpoint(cfg)
    if path is None:
        logger.info("Testing with random initialization (no checkpoint found).")
        return None
    model.load_state_dict(load_state_dict_file(path), strict=True)
    logger.info("Loaded checkpoint %s", path)
    if cfg.TEST.USE_EMA:
        logger.warning("TEST.USE_EMA requested but %s carries no EMA weights; "
                       "evaluating raw params.", path)
    return path
