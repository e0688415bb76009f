"""Primitive ops (NHWC layout).

These are the building blocks under ``mimo_unet_tpu.models``: convolutions
with reflect padding, pooling (with torch-compatible argmax indices for the
unpooling variant), align-corners bilinear upsampling, batch normalization
with torch running-stat semantics, and dropout variants.

All functions are pure, shape-static and jit/vmap/shard-safe.
"""

from mimo_unet_tpu.ops.conv import conv2d, conv2d_init, conv_transpose2d, conv_transpose2d_init
from mimo_unet_tpu.ops.resize import upsample_bilinear_x2_align_corners, pad_to_match
from mimo_unet_tpu.ops.pooling import max_pool_2x2, max_pool_2x2_with_indices, max_unpool_2x2
from mimo_unet_tpu.ops.norm import batch_norm, batch_norm_init
from mimo_unet_tpu.ops.dropout import dropout, dropout2d

__all__ = [
    "conv2d", "conv2d_init", "conv_transpose2d", "conv_transpose2d_init",
    "upsample_bilinear_x2_align_corners", "pad_to_match",
    "max_pool_2x2", "max_pool_2x2_with_indices", "max_unpool_2x2",
    "batch_norm", "batch_norm_init",
    "dropout", "dropout2d",
]
