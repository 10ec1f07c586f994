"""Ops of the port: coordinates, resampling, vector quantization, the TPS
warps of the equivariance loss, deformable convolution and StyleGAN2's
resampling ops (off the main paths), and kernel K1 (fused attention; K2, its
head-split layout, is ``ops.fused_attention.fused_attention``). Kernels K3
and K4 are in the module ``ops.conv3x3`` (its function of the same name
is not re-exported here, so that ``ops.conv3x3`` stays the module)."""
from .coords import (
    antialias_downsample,
    antialias_weight,
    convex_hull_area,
    kp2gaussian,
    make_coordinate_grid,
    softargmax_kp,
)
from .dcn import deform_conv2d, modulated_deform_conv2d
from .fused_attention import (
    fused_attention_packed,
    fused_attention_packed_reference,
)
from .interp import (
    avg_pool_2x,
    grid_sample,
    grid_sample_grouped,
    interpolate_flow,
    resize_bilinear,
    resize_bilinear_at,
    resize_nearest,
    resize_tap_plan,
    tap_reduce,
    upsample_nearest,
)
from .stylegan_ops import fused_leaky_relu, make_resample_kernel, upfirdn2d
from .tps import (
    RandomTPSParams,
    sample_random_tps,
    tps_jacobian,
    tps_warp_coordinates,
    tps_warp_frame_grid,
)
from .vq import vq_lookup, vq_nearest_indices, vq_quantize

__all__ = [
    "RandomTPSParams", "antialias_downsample", "antialias_weight",
    "avg_pool_2x", "convex_hull_area", "deform_conv2d",
    "fused_attention_packed", "fused_attention_packed_reference",
    "fused_leaky_relu", "make_resample_kernel", "modulated_deform_conv2d",
    "grid_sample", "grid_sample_grouped", "interpolate_flow", "kp2gaussian",
    "make_coordinate_grid", "resize_bilinear", "resize_bilinear_at",
    "resize_nearest", "resize_tap_plan", "sample_random_tps", "softargmax_kp", "tap_reduce",
    "tps_jacobian", "tps_warp_coordinates", "tps_warp_frame_grid",
    "upfirdn2d", "upsample_nearest", "vq_lookup", "vq_nearest_indices", "vq_quantize",
]
