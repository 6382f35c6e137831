"""Several processes: the process group, its collectives and the wrapping of
a model for data-parallel training (``csts_tpu/parallel``'s data axis)."""
