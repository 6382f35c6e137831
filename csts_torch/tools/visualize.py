"""Prediction/label heatmap overlays (and the fusion blocks' attention maps)
for test clips, the JAX package's ``tools/visualize.py`` with its flags:

    python -m csts_torch.tools.visualize --cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml \\
        [--num-clips 4] [--attention] [--out DIR] [--device cpu] TEST.CHECKPOINT_FILE_PATH w.npz

Output goes to ``OUTPUT_DIR/visualization/clipNNNN/`` (or ``--out``): per
frame a side-by-side prediction/label overlay, and with ``--attention`` the
spatial fusion's audio→video maps per head and frame and the temporal
fusion's matrix per head, all PNG (``csts_torch.eval.visualize``). It runs
on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--num-clips", type=int, default=4)
    parser.add_argument("--attention", action="store_true",
                        help="also dump spatial/temporal fusion attention maps")
    parser.add_argument("--out", default=None, help="override output directory")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, an error without it)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    args = parser.parse_args(argv)

    from csts_torch.config import load_config
    from csts_torch.eval.visualize import run_visualization

    cfg = load_config(args.cfg, args.opts)
    out = run_visualization(cfg, num_clips=args.num_clips, attention=args.attention,
                            out_dir=args.out, device=args.device)
    print(f"overlays written to {out}")
    return out


if __name__ == "__main__":
    main()
