"""The visualization runner: a checkpoint and the test split -> overlay dumps
(``csts_tpu/eval/visualize.py``).

``run_visualization(cfg)`` loads the weights as the tester does (the test
checkpoint chain), runs the eval forward over the first ``num_clips`` test
clips and writes, per clip under ``OUTPUT_DIR/visualization/clipNNNN/``, the
per-frame prediction/label overlays and, with ``attention``, the spatial
fusion's audio→video maps and the temporal fusion's matrices
(``eval/visualization.py``; reference ``vis_av_st_fusion``,
``slowfast/visualization/visualization.py:172-228``). It runs on CUDA unless
``device`` names another device. The loader is closed when it returns or
raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from csts_torch import resolve_device
from csts_torch.config import Config
from csts_torch.data import loader as loader_lib
from csts_torch.eval import metrics, visualization as vis
from csts_torch.models.csts import CSTS, build_spec, init_params
from csts_torch.train import losses
from csts_torch.utils import checkpoint as cu
from csts_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def _denormalize(video: np.ndarray, mean, std) -> np.ndarray:
    """A batch's video as fed to the model -> normalised float frames: a
    uint8 feed (DATA_LOADER.UINT8_TRANSFER) is normalised here, a float
    feed already is."""
    if video.dtype == np.uint8:
        return (video.astype(np.float32) / 255.0 - np.asarray(mean, np.float32)) / np.asarray(
            std, np.float32)
    return video.astype(np.float32)


def run_visualization(cfg: Config, num_clips: int = 4, attention: bool = False,
                      out_dir: Optional[str] = None, device=None) -> str:
    """Dumps overlays for the first ``num_clips`` test clips; returns the
    directory."""
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    out_dir = out_dir or os.path.join(cfg.OUTPUT_DIR, "visualization")
    spec = build_spec(cfg)
    model = CSTS(spec)
    cu.load_test_checkpoint(cfg, model, init=lambda: init_params(
        model, torch.Generator().manual_seed(cfg.RNG_SEED)))
    if cfg.TRAIN.MIXED_PRECISION:
        model = model.to(torch.bfloat16)
    model = model.to(device).eval()
    mean, std = cfg.DATA.MEAN, cfg.DATA.STD
    done = 0
    with loader_lib.construct_loader(cfg, "test", device) as loader, \
            loader_lib.DevicePrefetcher(iter(loader), device,
                                        depth=cfg.DATA_LOADER.PREFETCH_DEPTH) as prefetch:
        for batch in prefetch:
            with torch.inference_mode():
                out = model(batch["video"], batch["audio"], return_spatial_attn=attention,
                            return_temporal_attn=attention)
                logits = out[0] if attention else out
                preds = metrics.minmax_rescale(
                    losses.frame_softmax(logits, temperature=2.0)[..., 0])
            preds = preds.float().cpu().numpy()
            video = batch["video"].cpu().numpy()
            labels_hm = batch["labels_hm"].float().cpu().numpy()
            for i in range(video.shape[0]):
                if done >= num_clips:
                    break
                clip_dir = os.path.join(out_dir, f"clip{done:04d}")
                frames = _denormalize(video[i], mean, std)
                vis.vis_inference(clip_dir, frames, preds[i], labels_hm[i], mean=mean, std=std)
                if attention:
                    vis.vis_spatial_attention(os.path.join(clip_dir, "spatial_attn"), frames,
                                              out[1][i].float().cpu().numpy(), spec.fusion_thw,
                                              mean=mean, std=std)
                    vis.vis_temporal_attention(os.path.join(clip_dir, "temporal_attn"),
                                               out[2][i].float().cpu().numpy())
                done += 1
            if done >= num_clips:
                break
    logger.info("Wrote %d clips to %s", done, out_dir)
    return out_dir
