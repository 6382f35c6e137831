from .common import gelu, linear, mlp
from .conv import conv3d, depthwise_conv3d, depthwise_conv_transpose3d, max_pool3d
from .norm import layer_norm
from .resize import trilinear_resize

__all__ = [
    "gelu",
    "linear",
    "mlp",
    "conv3d",
    "depthwise_conv3d",
    "depthwise_conv_transpose3d",
    "max_pool3d",
    "layer_norm",
    "trilinear_resize",
]
