"""Offline export of an npz archive's params into a reference ``.pyth``, the
JAX package's ``tools/export_checkpoint.py`` with the same flags:

    python -m csts_torch.tools.export_checkpoint --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        --input checkpoints/checkpoint_epoch_00015.npz --output csts_exported.pyth [--epoch N]

The inverse of ``convert_checkpoint``: the archive's params (either
package's trainer or a params archive, ``utils/checkpoint.load_params_npz``)
in the model of ``--cfg``, written as ``{"epoch", "model_state"}`` in the
reference's module names and layouts, which the port's parameters carry.
The epoch defaults to the sidecar's (0 without one).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--input", required=True, help=".npz params archive")
    ap.add_argument("--output", required=True, help=".pyth output path")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch to record (default: the archive's metadata)")
    args = ap.parse_args(argv)

    import torch

    from csts_torch.models.csts import CSTS, build_spec
    from csts_torch.tools.inspect_checkpoint import load_cfg
    from csts_torch.utils import checkpoint as cu

    model = CSTS(build_spec(load_cfg(args.cfg)))
    cu.load_params_npz(args.input, model)
    epoch = args.epoch
    if epoch is None:
        epoch = 0
        if os.path.exists(args.input + ".json"):
            with open(args.input + ".json") as f:
                epoch = json.load(f).get("epoch", 0)
    sd = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.save({"epoch": int(epoch), "model_state": sd}, args.output)
    print(f"wrote {args.output} (epoch {epoch})")


if __name__ == "__main__":
    main()
