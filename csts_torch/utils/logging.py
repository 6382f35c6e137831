"""Logging: rank 0's stdout + file, structured JSON stat lines
(``csts_tpu/utils/logging.py``; reference ``slowfast/utils/logging.py:19-96``).

``json_stats:`` lines are the machine-readable record ("train_iter",
"val_epoch", "test_final" types). With several processes only rank 0 logs:
the others' root logger gets a null handler, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict

from csts_torch.parallel import collectives


def setup_logging(output_dir: str | None = None) -> None:
    """Root logger to stdout, and to ``output_dir/stdout.log`` when given;
    on ranks other than 0, nowhere."""
    if not collectives.is_master_proc():
        logging.getLogger().addHandler(logging.NullHandler())
        return
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(name)s: %(lineno)4d: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
        fh.setFormatter(fmt)
        root.addHandler(fh)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def log_json_stats(stats: Dict[str, Any]) -> None:
    """``json_stats: {...}`` record (logging.py:87-96), 5-decimal floats."""
    rounded = {
        k: (round(v, 5) if isinstance(v, float) else v) for k, v in stats.items()
    }
    get_logger(__name__).info("json_stats: {:s}".format(json.dumps(rounded, sort_keys=True)))
