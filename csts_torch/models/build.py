"""Model registry and builder (``csts_tpu/models/build.py``; reference
``slowfast/models/build.py:9-47``).

A model family registers a builder that takes the config and returns its
``nn.Module``. The JAX package's builders return the functional triplet
``(spec, init_fn, apply_fn)``; in PyTorch's idiom the module is all three:
``model.spec`` is the spec, the builder has already run the init (the port's
seeded weights from ``cfg.RNG_SEED``, to be replaced by ``load_state_dict``),
and ``model(...)`` is the apply.
"""

from __future__ import annotations

import torch
from torch import nn

from csts_torch import resolve_device
from csts_torch.config import Config
from csts_torch.utils.registry import Registry

MODEL_REGISTRY = Registry("MODEL")


def build_model(cfg: Config, device=None) -> nn.Module:
    """The model of ``cfg.MODEL.MODEL_NAME`` ("CSTS" or "MVIT") with seeded
    fp32 weights, on ``device``: CUDA unless the caller names another
    (:func:`csts_torch.resolve_device`). Activations run in the spec's
    compute dtype (bf16 under TRAIN.MIXED_PRECISION) whatever the weights'."""
    from csts_torch.models import mvit_classifier  # noqa: F401  (registers "MVIT")

    device = resolve_device(device)
    return MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(cfg).to(device)


@MODEL_REGISTRY.register("CSTS")
def _build_csts(cfg: Config) -> nn.Module:
    from csts_torch.models.csts import CSTS, build_spec, init_params

    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    return model
