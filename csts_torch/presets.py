"""Named configurations of the model family.

``flagship_cfg`` is CSTS-B 16x4 at 256² video and a 256² audio STFT, the model
the serving path runs; ``flagship_train_cfg`` the same model as it trains;
``small_cfg`` is the reduced family member (crop 32,
depth 4, width 16) with the same four-stage structure, for CPU checks.
"""

from __future__ import annotations

from csts_torch.config import Config, get_cfg


def flagship_cfg() -> Config:
    cfg = get_cfg()
    cfg.DATA.TRAIN_CROP_SIZE = 256
    cfg.DATA.TEST_CROP_SIZE = 256
    cfg.DATA.NUM_FRAMES = 8
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.CLS_EMBED_ON = False
    cfg.MVIT.SEP_POS_EMBED = True
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.MVIT.DEPTH = 16
    cfg.MVIT.EMBED_DIM = 96
    cfg.MVIT.DIM_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 8, 8]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]]
    cfg.MODEL.LOSS_FUNC = "kldiv+egonce"
    cfg.MODEL.LOSS_ALPHA = 0.05
    cfg.SOLVER.BASE_LR = 1e-4
    cfg.SOLVER.COSINE_END_LR = 1e-6
    cfg.SOLVER.MAX_EPOCH = 15
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.CLIP_GRAD_L2NORM = 1.0
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    return cfg


def small_cfg(batch: int) -> Config:
    """Reduced family member: same 4-stage structure at crop 32, depth 4."""
    cfg = flagship_cfg()
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.AUDIO_FREQ_BINS = 32
    cfg.DATA.AUDIO_WINDOW = 32
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]
    cfg.TRAIN.BATCH_SIZE = batch
    return cfg


def flagship_train_cfg() -> Config:
    """The flagship as it trains: bf16 compute over fp32 master weights
    (TRAIN.MIXED_PRECISION), batch 8 (TRAIN.BATCH_SIZE of
    configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml)."""
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    cfg.TRAIN.BATCH_SIZE = 8
    return cfg
