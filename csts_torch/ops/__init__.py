from .common import drop_path, gelu, linear, mlp, sample_drop_masks
from .conv import conv3d, depthwise_conv3d, depthwise_conv_transpose3d, max_pool3d
from .norm import layer_norm
from .resize import trilinear_resize

__all__ = [
    "drop_path",
    "gelu",
    "linear",
    "mlp",
    "conv3d",
    "depthwise_conv3d",
    "depthwise_conv_transpose3d",
    "max_pool3d",
    "layer_norm",
    "sample_drop_masks",
    "trilinear_resize",
]
