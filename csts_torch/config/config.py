"""Typed configuration system, the PyTorch port's own copy of
``csts_tpu/config/config.py`` (same keys, defaults and merge rules; the port
imports nothing of the JAX package). YAML files are read by the port's own
reader of the configs' subset (``config/yaml_subset.py``), never PyYAML, so
the CPU and the card, which has no PyYAML, read a config by the same path.

Capability parity with the reference fvcore-CfgNode config
(``slowfast/config/defaults.py:12-977`` + ``custom_config.py:8-25``), redesigned as
frozen-after-load typed dataclasses:

* defaults live in the dataclass field definitions,
* a YAML file (same section/key schema as the reference's shipped configs) is merged on top,
* trailing ``KEY VALUE`` CLI overrides are merged last (``parser.py:74-86`` equivalent),
* unknown keys raise instead of being silently accepted,
* derived values / validation happen in :func:`finalize` (``defaults.py:945-970``).

Only the sections/keys actually exercised by the CSTS model family are typed; the
reference's dead sections (RESNET, X3D, NONLOCAL, SLOWFAST, AVA, MULTIGRID, DETECTION,
DEMO) are intentionally not carried over — they configure models the reference itself
never builds in this fork.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from csts_torch.config import yaml_subset


def _f(default):
    return field(default_factory=lambda: copy.deepcopy(default))


@dataclass
class TrainConfig:
    """Reference: ``defaults.py:42-79`` (TRAIN section) + custom_config.py."""

    ENABLE: bool = True
    DATASET: str = "ego4d_av_gaze_forecast"
    BATCH_SIZE: int = 64  # global batch size across all devices
    EVAL_PERIOD: int = 10
    CHECKPOINT_PERIOD: int = 10
    AUTO_RESUME: bool = True
    CHECKPOINT_FILE_PATH: str = ""
    CHECKPOINT_TYPE: str = "pytorch"  # "pytorch" (converted .pyth) or "jax"
    CHECKPOINT_EPOCH_RESET: bool = False
    CHECKPOINT_CLEAR_NAME_PATTERN: Tuple[str, ...] = ()
    MIXED_PRECISION: bool = False  # bf16 activations on TPU (no loss scaler needed)
    # micro-batch gradient accumulation (new capability): effective batch =
    # BATCH_SIZE, device batch = BATCH_SIZE / GRAD_ACCUM_STEPS. With kldiv+egonce
    # the accumulation is two-pass so NCE negatives stay global (train/step.py).
    GRAD_ACCUM_STEPS: int = 1
    # custom_config.py:18 — separate audio-branch init checkpoint
    AUDIO_CHECKPOINT_FILE_PATH: str = ""
    # "npz" (reference-style master-only files, utils/checkpoint.py) or "orbax"
    # (async sharding-aware multihost backend, utils/orbax_ckpt.py)
    CHECKPOINT_BACKEND: str = "npz"
    # In-trainer device profiling: capture a jax.profiler trace of iterations
    # [PROFILE_START_ITER, PROFILE_START_ITER + PROFILE_NUM_ITERS) of the first
    # trained epoch to OUTPUT_DIR/profile (0 iters = off). The offline analyzer
    # tools/profile_forward.py reads the same trace format.
    PROFILE_START_ITER: int = 0
    PROFILE_NUM_ITERS: int = 0


@dataclass
class TestConfig:
    """Reference: ``defaults.py:140-166``."""

    ENABLE: bool = True
    DATASET: str = "ego4d_av_gaze_forecast"
    BATCH_SIZE: int = 8
    CHECKPOINT_FILE_PATH: str = ""
    NUM_ENSEMBLE_VIEWS: int = 10
    NUM_SPATIAL_CROPS: int = 3
    CHECKPOINT_TYPE: str = "pytorch"
    SAVE_RESULTS_PATH: str = ""
    # Sliding-window full-frame eval used by the estimation datasets
    # (referenced at ego4d_avgaze.py:118 but never defined in the reference's
    # config — a latent AttributeError there; defined here with a sane default).
    FULL_FRAME_TEST: bool = False
    # Evaluate the EMA weights when the checkpoint carries them
    # (SOLVER.EMA_DECAY > 0 training runs).
    USE_EMA: bool = False


@dataclass
class DataConfig:
    """Reference: ``defaults.py:409-497`` + ``custom_config.py:10``."""

    PATH_TO_DATA_DIR: str = ""
    PATH_LABEL_SEPARATOR: str = ","
    PATH_PREFIX: str = ""
    NUM_FRAMES: int = 8
    SAMPLING_RATE: int = 8
    MEAN: List[float] = _f([0.45, 0.45, 0.45])
    STD: List[float] = _f([0.225, 0.225, 0.225])
    INPUT_CHANNEL_NUM: List[int] = _f([3, 3])
    TRAIN_JITTER_SCALES: List[int] = _f([256, 320])
    TRAIN_CROP_SIZE: int = 224
    TEST_CROP_SIZE: int = 256
    TARGET_FPS: int = 30
    USE_OFFSET_SAMPLING: bool = False
    RANDOM_FLIP: bool = True
    DECODING_BACKEND: str = "pyav"
    ENSEMBLE_METHOD: str = "sum"
    # custom_config.py:10 — Gaussian kernel size for label heatmaps
    GAUSSIAN_KERNEL: int = 19
    # Audio STFT slice geometry (the reference hard-codes 256×256: 256 freq bins from
    # n_fft 511, ±128 hop columns per frame — ego4d_avgaze.py:249-255). Configurable
    # here; the model's audio branch derives its token grid from these.
    AUDIO_FREQ_BINS: int = 256
    AUDIO_WINDOW: int = 256


@dataclass
class MViTConfig:
    """Reference: ``defaults.py:300-383`` + ``custom_config.py:25``."""

    MODE: str = "conv"
    POOL_FIRST: bool = False
    CLS_EMBED_ON: bool = True
    AUDIO_BRANCH_ON: bool = False
    PATCH_KERNEL: List[int] = _f([3, 7, 7])
    PATCH_STRIDE: List[int] = _f([2, 4, 4])
    PATCH_PADDING: List[int] = _f([2, 4, 4])
    PATCH_2D: bool = False
    EMBED_DIM: int = 96
    NUM_HEADS: int = 1
    MLP_RATIO: float = 4.0
    QKV_BIAS: bool = True
    DROPPATH_RATE: float = 0.1
    DEPTH: int = 16
    NORM: str = "layernorm"
    DIM_MUL: List[List[float]] = _f([])
    HEAD_MUL: List[List[float]] = _f([])
    POOL_KV_STRIDE: Optional[List[List[int]]] = None
    POOL_KV_STRIDE_ADAPTIVE: Optional[List[int]] = None
    POOL_Q_STRIDE: List[List[int]] = _f([])
    POOL_KVQ_KERNEL: Optional[List[int]] = None
    ZERO_DECAY_POS_CLS: bool = True
    NORM_STEM: bool = False
    SEP_POS_EMBED: bool = False
    DROPOUT_RATE: float = 0.0
    # custom_config.py:25 — reweight temporal-fusion input by spatial audio attention
    SPATIAL_AUDIO_ATTN: bool = False


@dataclass
class ModelConfig:
    """Reference: ``defaults.py:263-297`` + ``custom_config.py:22``."""

    ARCH: str = "mvit"
    MODEL_NAME: str = "CSTS"
    NUM_CLASSES: int = 400
    LOSS_FUNC: str = "cross_entropy"
    DROPOUT_RATE: float = 0.5
    HEAD_ACT: str = "softmax"
    ACT_CHECKPOINT: bool = False  # jax.checkpoint (rematerialization) on encoder blocks
    # Pallas VMEM-resident attention kernel (auto-disabled off-TPU). New capability.
    FUSED_ATTENTION: bool = True
    # custom_config.py:22 — weight on the EgoNCE term of kldiv+egonce
    LOSS_ALPHA: float = 1.0


@dataclass
class SolverConfig:
    """Reference: ``defaults.py:502-566``."""

    BASE_LR: float = 0.1
    LR_POLICY: str = "cosine"
    COSINE_END_LR: float = 0.0
    GAMMA: float = 0.1
    STEP_SIZE: int = 1
    STEPS: List[int] = _f([])
    LRS: List[float] = _f([])
    MAX_EPOCH: int = 300
    MOMENTUM: float = 0.9
    DAMPENING: float = 0.0
    NESTEROV: bool = True
    WEIGHT_DECAY: float = 1e-4
    WARMUP_FACTOR: float = 0.1
    WARMUP_EPOCHS: float = 0.0
    WARMUP_START_LR: float = 0.01
    OPTIMIZING_METHOD: str = "sgd"
    BASE_LR_SCALE_NUM_SHARDS: bool = False
    COSINE_AFTER_WARMUP: bool = False
    ZERO_WD_1D_PARAM: bool = False
    CLIP_GRAD_VAL: Optional[float] = None
    CLIP_GRAD_L2NORM: Optional[float] = None
    # ZeRO-1: shard Adam moments over the data axis (params stay replicated;
    # XLA turns the optimizer update into compute-on-shard + all-gather of the
    # updates). Beyond the reference, which is plain DDP (SURVEY §2.2).
    ZERO1: bool = False
    # ZeRO-3 / FSDP: shard params AND Adam moments over the data axis
    # (parallel/mesh.py fsdp_param_sharding — XLA gathers params on use and
    # reduce-scatters gradients). Subsumes ZERO1; composes with PARALLEL.MODEL.
    FSDP: bool = False
    # Store Adam's first moment in bfloat16 (optax mu_dtype): halves mu memory;
    # nu stays fp32 (grad² underflows bf16 near convergence).
    BF16_MOMENTS: bool = False
    # Polyak/EMA weight averaging: > 0 keeps an exponential moving average of
    # the params in the TrainState (decay per step); the trainer's validation
    # and (with TEST.USE_EMA) the tester evaluate the smoothed weights.
    EMA_DECAY: float = 0.0


@dataclass
class BNConfig:
    """Reference: ``defaults.py:16-37``. MViT is LayerNorm-only; kept for parity."""

    USE_PRECISE_STATS: bool = False
    NUM_BATCHES_PRECISE: int = 200
    WEIGHT_DECAY: float = 0.0
    NORM_TYPE: str = "batchnorm"


@dataclass
class DataLoaderConfig:
    """Reference: ``defaults.py:613-623`` + ``custom_config.py:14``."""

    NUM_WORKERS: int = 8
    PIN_MEMORY: bool = True
    PREFETCH_DEPTH: int = 2  # device prefetch depth (TPU double-buffering), new
    # ship uint8 video (+ fp16 audio) to the device and fold /255+mean/std into the
    # jitted step — 4× less h2d than the reference's fp32 feed (utils.py:290-307), new
    UINT8_TRANSFER: bool = True
    # custom_config.py:14 — forecast datasets also return the future target frames
    RETURN_TARGET_FRAME: bool = False


@dataclass
class AugConfig:
    """RandAugment/RandomErasing (reference: ``defaults.py`` AUG section; off in the
    shipped CSTS configs)."""

    ENABLE: bool = False
    NUM_SAMPLE: int = 1
    AA_TYPE: str = "rand-m7-n4-mstd0.5-inc1"
    INTERPOLATION: str = "bicubic"
    RE_PROB: float = 0.25
    RE_MODE: str = "pixel"
    RE_COUNT: int = 1


@dataclass
class TBConfusionMatrixConfig:
    """tensorboard_vis.py:31-47 / defaults.py TENSORBOARD.CONFUSION_MATRIX."""

    ENABLE: bool = False
    FIGSIZE: list = field(default_factory=lambda: [8, 8])
    SUBSET_PATH: str = ""  # json: list of class ids to plot as a subset


@dataclass
class TBHistogramConfig:
    """defaults.py TENSORBOARD.HISTOGRAM — top-k prediction histograms per class."""

    ENABLE: bool = False
    FIGSIZE: list = field(default_factory=lambda: [8, 8])
    TOPK: int = 10
    SUBSET_PATH: str = ""


@dataclass
class TensorboardConfig:
    ENABLE: bool = False
    LOG_DIR: str = ""
    # json file mapping class id -> name (defaults.py TENSORBOARD.CLASS_NAMES_PATH)
    CLASS_NAMES_PATH: str = ""
    CONFUSION_MATRIX: TBConfusionMatrixConfig = field(
        default_factory=TBConfusionMatrixConfig
    )
    HISTOGRAM: TBHistogramConfig = field(default_factory=TBHistogramConfig)


@dataclass
class ParallelConfig:
    """Mesh axis sizes beyond data parallelism (``parallel/mesh.py make_mesh``).

    No reference counterpart (its runtime is DDP-only, SURVEY §2.2); the defaults
    keep the parity data-only mesh. dp is derived:
    ``NUM_DEVICES / (MODEL * SEQ * PIPE)``.
    """

    # tensor parallelism (Megatron column/row rules on qkv/proj + MLP matmuls)
    MODEL: int = 1
    # context/sequence parallelism over the encoder token axis (seq_constraint)
    SEQ: int = 1
    # GPipe pipeline parallelism over the encoder's uniform identity-block run
    # (parallel/pipeline.py)
    PIPE: int = 1
    # microbatches per pipeline round; 0 = pipe size (bubble (S-1)/(M+S-1))
    PIPE_MICROBATCHES: int = 0


@dataclass
class Config:
    """Root config. Reference: ``defaults.py:569-608`` for the top-level keys."""

    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DATA: DataConfig = field(default_factory=DataConfig)
    MVIT: MViTConfig = field(default_factory=MViTConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    BN: BNConfig = field(default_factory=BNConfig)
    DATA_LOADER: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    AUG: AugConfig = field(default_factory=AugConfig)
    TENSORBOARD: TensorboardConfig = field(default_factory=TensorboardConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    # NUM_GPUS in the reference; renamed — these are TPU chips in a jax Mesh.
    NUM_DEVICES: int = 1
    # Multi-host shards (NUM_SHARDS analogue); each shard is a jax process.
    NUM_SHARDS: int = 1
    SHARD_ID: int = 0
    OUTPUT_DIR: str = "."
    RNG_SEED: int = 1
    LOG_PERIOD: int = 10
    LOG_MODEL_INFO: bool = True
    # jax_debug_nans tracing — the framework's sanitizer story (SURVEY §5 row 2):
    # faults at the first NaN-producing op instead of the reference's end-of-step
    # check_nan_losses guard (misc.py:26-33, kept as well in train.step).
    DEBUG_NANS: bool = False

    def finalize(self) -> "Config":
        """Validation + derived values (``assert_and_infer_cfg`` defaults.py:945-970)."""
        non_dp = self.PARALLEL.MODEL * self.PARALLEL.SEQ * self.PARALLEL.PIPE
        if self.NUM_DEVICES > 0:
            assert self.NUM_DEVICES % non_dp == 0, (
                f"NUM_DEVICES {self.NUM_DEVICES} must divide by "
                f"PARALLEL.MODEL*SEQ*PIPE = {non_dp}"
            )
        # the batch shards over the data axis only, whose size is
        # NUM_DEVICES / (model*seq*pipe)
        dp = max(self.NUM_DEVICES, 1) // non_dp if self.NUM_DEVICES > 0 else 1
        assert self.TRAIN.BATCH_SIZE % max(dp, 1) == 0, (
            f"TRAIN.BATCH_SIZE {self.TRAIN.BATCH_SIZE} must divide by the "
            f"data-axis size {dp} (NUM_DEVICES {self.NUM_DEVICES} / "
            f"PARALLEL axes {non_dp})"
        )
        assert self.TEST.BATCH_SIZE % max(dp, 1) == 0
        assert self.TEST.NUM_SPATIAL_CROPS in (1, 3)
        if self.SOLVER.BASE_LR_SCALE_NUM_SHARDS and self.NUM_SHARDS > 1:
            # Linear LR scaling across shards (defaults.py:963-966).
            self.SOLVER.BASE_LR *= self.NUM_SHARDS
            self.SOLVER.WARMUP_START_LR *= self.NUM_SHARDS
            self.SOLVER.COSINE_END_LR *= self.NUM_SHARDS
        return self

    def dump(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------------------
# YAML / CLI merging
# --------------------------------------------------------------------------------------

# Top-level YAML keys the reference accepts but this build ignores (legacy sections of
# the PySlowFast config tree that configure models/paths never used by CSTS).
_IGNORED_SECTIONS = {
    "RESNET", "X3D", "NONLOCAL", "SLOWFAST", "AVA", "MULTIGRID", "DETECTION",
    "DEMO", "BENCHMARK", "MIXUP",
}
# Key aliases: reference name -> our name.
_KEY_ALIASES = {"NUM_GPUS": "NUM_DEVICES"}


def _coerce(value: Any, target: Any, path: str) -> Any:
    """Coerce a YAML/CLI value to the type of the dataclass default."""
    if isinstance(value, str):
        # The reference YAMLs write tuples like ``(3, 7, 7)`` which PyYAML loads as str.
        stripped = value.strip()
        if stripped and stripped[0] in "([" and stripped[-1] in ")]":
            try:
                value = list(ast.literal_eval(stripped))
            except (ValueError, SyntaxError):
                pass
        elif stripped in ("None", "none", "null"):
            value = None
        elif stripped in ("True", "true"):
            value = True
        elif stripped in ("False", "false"):
            value = False
        else:
            try:
                value = ast.literal_eval(stripped)
            except (ValueError, SyntaxError):
                pass
    if target is None or value is None:
        return value
    if isinstance(target, bool):
        if not isinstance(value, bool):
            raise TypeError(f"{path}: expected bool, got {value!r}")
        return value
    if isinstance(target, int) and not isinstance(target, bool):
        if isinstance(value, float) and not value.is_integer():
            raise TypeError(f"{path}: expected int, got {value!r}")
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, (list, tuple)):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: expected sequence, got {value!r}")
        return type(target)(value)
    return value


def _merge_section(section_obj: Any, updates: dict, path: str) -> None:
    for key, value in updates.items():
        key = _KEY_ALIASES.get(key, key)
        if not hasattr(section_obj, key):
            raise KeyError(f"Unknown config key: {path}.{key}" if path else f"Unknown config key: {key}")
        current = getattr(section_obj, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise TypeError(f"{path}.{key}: expected a mapping")
            _merge_section(current, value, f"{path}.{key}" if path else key)
        else:
            setattr(section_obj, key, _coerce(value, current, f"{path}.{key}"))


def get_cfg() -> Config:
    """Fresh config with defaults (``get_cfg`` defaults.py:973-977)."""
    return Config()


def merge_from_dict(cfg: Config, d: dict) -> Config:
    ignored = sorted(k for k in d if k in _IGNORED_SECTIONS)
    if ignored:
        import warnings

        warnings.warn(
            "Ignoring legacy PySlowFast config section(s) never executed by the "
            f"CSTS paths: {', '.join(ignored)}",
            stacklevel=2,
        )
    d = {k: v for k, v in d.items() if k not in _IGNORED_SECTIONS}
    _merge_section(cfg, d, "")
    return cfg


def merge_from_list(cfg: Config, opts: List[str]) -> Config:
    """Merge ``KEY VALUE`` pairs, e.g. ``["TRAIN.BATCH_SIZE", "16"]`` (parser.py:84-86)."""
    assert len(opts) % 2 == 0, f"Override list must be KEY VALUE pairs, got {opts}"
    for key, value in zip(opts[0::2], opts[1::2]):
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            p = _KEY_ALIASES.get(p, p)
            if not hasattr(obj, p):
                raise KeyError(f"Unknown config section: {key}")
            obj = getattr(obj, p)
        leaf = _KEY_ALIASES.get(parts[-1], parts[-1])
        if not hasattr(obj, leaf):
            raise KeyError(f"Unknown config key: {key}")
        setattr(obj, leaf, _coerce(value, getattr(obj, leaf), key))
    return cfg


def load_config(
    cfg_file: Optional[str] = None,
    opts: Optional[List[str]] = None,
    output_dir: Optional[str] = None,
) -> Config:
    """Build a config: defaults <- YAML <- CLI overrides (``load_config`` parser.py:67-94)."""
    cfg = get_cfg()
    if cfg_file:
        merge_from_dict(cfg, yaml_subset.load_file(cfg_file) or {})
    if opts:
        merge_from_list(cfg, opts)
    if output_dir:
        cfg.OUTPUT_DIR = output_dir
    cfg.finalize()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return cfg
