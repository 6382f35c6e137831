"""CSTS in PyTorch for NVIDIA Hopper.

The port of the JAX/TPU package ``csts_tpu``: the same model, weights layout
and serving API, with hand-written CUDA kernels in place of the Pallas ones.
It imports nothing of JAX or of ``csts_tpu``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when no device is given and CUDA is absent, so a run never drops to
    the CPU without being asked to.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "csts_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return torch.device("cuda")
