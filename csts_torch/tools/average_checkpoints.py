"""Average N checkpoints into one (checkpoint soup / offline SWA), the JAX
package's ``tools/average_checkpoints.py`` with the same flags:

    python -m csts_torch.tools.average_checkpoints a.npz b.npz ... --output soup.npz
    python -m csts_torch.tools.average_checkpoints OUTPUT_DIR/checkpoints/*.npz --last 3 \\
        --output soup.npz [--cfg CFG.yaml]

Only the weights are averaged, in fp64 and cast back to each leaf's dtype:
the P parameter leaves, and the P EMA leaves of a TrainState archive that
has them. P comes from ``--cfg`` (``convert/to_jax.param_leaf_names``), or
else from the archive's own layout: the params lead, and the first 0-d leaf
(the optimizer's count) ends them; an archive with no 0-d leaf holds params
only. The optimizer's counts, learning rate and moments come from the last
input unchanged, so the output still resumes as a TrainState and serves
through ``load_params_npz`` / ``GazePredictor``. The sidecar is the last
input's, with ``averaged_from``. Inputs are used in the order given and
must agree in leaves and shapes.

The JAX tool, without ``--cfg``, averages every leaf, the moments and
counts too, and with ``--cfg`` it leaves the EMA leaves unaveraged.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import List, Optional

import numpy as np


def _has_ema(n_leaves: int, n_params: int) -> bool:
    """AdamW/Adam 4P+4 (3P+4 without the EMA), SGD 3P+3 (2P+3 without)."""
    return n_leaves in (4 * n_params + 4, 3 * n_params + 3)


def weight_leaves(leaves: List[np.ndarray], n_params: Optional[int] = None) -> List[int]:
    """The indices of the leaves to average: the params, and the EMA's P
    leaves where the archive has them."""
    n = len(leaves)
    if n_params is None:
        n_params = next((i for i, a in enumerate(leaves) if a.ndim == 0), n)
    idx = list(range(n_params))
    if n_params < n and _has_ema(n, n_params):
        ema = range(n - n_params, n)
        if all(leaves[i].shape == leaves[j].shape for i, j in zip(idx, ema)):
            idx += list(ema)
    return idx


def average(paths, output, n_params: Optional[int] = None):
    blobs = [np.load(p) for p in paths]
    keys = sorted(blobs[0].files)
    for p, b in zip(paths[1:], blobs[1:]):
        if sorted(b.files) != keys:
            raise ValueError(f"{p}: leaf set differs from {paths[0]}")
    last = [blobs[-1][k] for k in keys]
    chosen = set(weight_leaves(last, n_params))
    out = {}
    for i, k in enumerate(keys):
        ref = last[i]
        if i in chosen:
            acc = np.zeros(ref.shape, np.float64)
            for p, b in zip(paths, blobs):
                arr = b[k]
                if arr.shape != ref.shape:
                    raise ValueError(f"{p} {k}: shape {arr.shape}, the last input's {ref.shape}")
                acc += np.asarray(arr, np.float64)
            out[k] = (acc / len(blobs)).astype(ref.dtype)
        else:
            out[k] = ref  # optimizer state: the last checkpoint's, unaveraged
    np.savez(output, **out)

    sidecar = paths[-1] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        meta["averaged_from"] = [os.path.basename(p) for p in paths]
        with open(output + ".json", "w") as f:
            json.dump(meta, f)
    return len(keys), len(chosen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+",
                    help=".npz checkpoints, oldest first (the last donates opt state)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--last", type=int, default=0, help="use only the last N inputs as given")
    ap.add_argument("--cfg", default=None,
                    help="YAML config: the param leaf count from the model (else from the "
                         "archive's layout)")
    args = ap.parse_args(argv)

    paths = [p for p in args.inputs if re.search(r"\.npz$", p)]
    if args.last:
        paths = paths[-args.last:]
    if len(paths) < 2:
        raise ValueError(f"need >= 2 checkpoints, got {paths}")
    n_params = None
    if args.cfg:
        from csts_torch.tools.inspect_checkpoint import param_names

        n_params = len(param_names(args.cfg))
    total, averaged = average(paths, args.output, n_params)
    print(f"averaged {averaged}/{total} leaves of {len(paths)} checkpoints -> {args.output}")


if __name__ == "__main__":
    main()
