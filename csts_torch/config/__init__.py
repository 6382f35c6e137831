from .config import (
    Config,
    BNConfig,
    DataConfig,
    DataLoaderConfig,
    MViTConfig,
    ModelConfig,
    SolverConfig,
    TensorboardConfig,
    TestConfig,
    TrainConfig,
    get_cfg,
    load_config,
)

__all__ = [
    "Config",
    "BNConfig",
    "DataConfig",
    "DataLoaderConfig",
    "MViTConfig",
    "ModelConfig",
    "SolverConfig",
    "TensorboardConfig",
    "TestConfig",
    "TrainConfig",
    "get_cfg",
    "load_config",
]
