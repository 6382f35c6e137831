"""Offline conversion of a reference ``.pyth`` into an npz params archive, the
JAX package's ``tools/convert_checkpoint.py`` with the same flags:

    python -m csts_torch.tools.convert_checkpoint --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        --input csts_ego4d_forecast.pyth --output weights.npz [--audio-checkpoint audio_mvit.pyth]

The model of ``--cfg`` with its seeded initialisation (RNG_SEED), then the
trainer's fine-tune merge (``utils/checkpoint.load_torch_weights``: shapes
matched, position embeddings resampled) and the audio branch; written as
the P parameter leaves in the JAX flatten order with an ``epoch -1``
sidecar, which ``load_params_npz``, ``GazePredictor.from_checkpoint`` and
the JAX package's loaders read. A leaf the ``.pyth`` does not cover keeps
the port's seeded initialisation, which is not the JAX package's.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--input", required=True, help=".pyth checkpoint")
    ap.add_argument("--output", required=True, help=".npz output path")
    ap.add_argument("--audio-checkpoint", default=None,
                    help="separate audio-branch MViT .pyth to merge")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from csts_torch.convert import to_jax
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.tools.inspect_checkpoint import load_cfg
    from csts_torch.utils import checkpoint as cu

    cfg = load_cfg(args.cfg)
    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    cu.load_torch_weights(args.input, model)
    if args.audio_checkpoint:
        cu.load_audio_branch(args.audio_checkpoint, model)
    named = dict(model.named_parameters())
    leaves = [to_jax.to_jax_leaf(named[leaf.name], leaf.perm)
              for _, leaf in to_jax.layout(list(named))]
    np.savez(args.output, **{f"leaf_{i:05d}": a for i, a in enumerate(leaves)})
    with open(args.output + ".json", "w") as f:
        json.dump({"epoch": -1, "num_leaves": len(leaves), "cfg": cfg.dump()}, f)
    print(f"wrote {args.output} ({len(leaves)} leaves)")


if __name__ == "__main__":
    main()
