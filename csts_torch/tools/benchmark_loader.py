"""The input pipeline's rate alone (``tools/benchmark_loader.py``; reference
``slowfast/utils/benchmark.py``): batches/s and clips/s of the train loader,
no device work.

    python -m csts_torch.tools.benchmark_loader --cfg X.yaml [--batches 20] [KEY VALUE ...]

Prints the JSON stats line (``utils.misc.benchmark_data_loading``); the
loader and its workers are closed before it returns.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from csts_torch.config import load_config
    from csts_torch.utils.logging import setup_logging
    from csts_torch.utils.misc import benchmark_data_loading

    cfg = load_config(args.cfg, args.opts or None)
    setup_logging(cfg.OUTPUT_DIR)
    stats = benchmark_data_loading(cfg, args.batches)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":  # the loader's fork server imports this module
    main()
