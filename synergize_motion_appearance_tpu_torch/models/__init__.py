"""Networks of the reenactment and training paths, and their registry.

``build_network({'type': ..., **kwargs})`` takes the same ``type`` strings
as the JAX package's, including the reference aliases
``Motion_Estimator_keypoint_aware`` and ``AutoEncoder_MSDecoder``.
"""
from typing import Any, Dict

from ..utils.registry import ARCH_REGISTRY
from .appmotion_former import AppMotionCompFormer
from .arch_util import (DCNv2Pack, ModulatedDeformConvPack, ResidualBlockNoBN,
                        Upsample, flow_warp, make_layer, resize_flow,
                        scaled_conv_kernel_init, trunc_normal_init)
from .dense_motion import DenseMotionNetwork, MotionEstimator
from .keypoint_detector import KPDetector
from .transformer import MultiheadAttention, TransformerLayer
from .vgg import VGG19Features, VGGFeatureExtractor
from .vqgan import (AutoEncoder, Encoder, Generator, VectorQuantizer,
                    VQAutoEncoder, VQGANDiscriminator)
from .vqgan_extras import (AutoEncoderMSDecoder, FuseFeatBlock,
                           GumbelQuantizer, MSGenerator)

for _cls in (KPDetector, DenseMotionNetwork, MotionEstimator,
             VQAutoEncoder, AutoEncoder, VQGANDiscriminator,
             AppMotionCompFormer, VGGFeatureExtractor):
    ARCH_REGISTRY.register(_cls)
# reference aliases (archs/motion_estimator_arch.py:15, vqgan_arch.py:629)
ARCH_REGISTRY.register(MotionEstimator,
                       name="Motion_Estimator_keypoint_aware")
ARCH_REGISTRY.register(AutoEncoderMSDecoder, name="AutoEncoder_MSDecoder")


# keys of the JAX configs that the port does not take: they choose the
# TPU's W-in-lanes layout (wl_*; the port's training forward always runs
# its decoder region on kernel K3, and inference never does)
_IGNORED = ("wl_decoder", "wl_train", "wl_xlr")


def _port_options(opt: Dict[str, Any]) -> Dict[str, Any]:
    """``opt`` (and its nested dicts) without the ignored keys."""
    return {key: (_port_options(value) if isinstance(value, dict) else value)
            for key, value in opt.items() if key not in _IGNORED}


def build_network(opt: Dict[str, Any]):
    """Instantiate a network from a config dict with a 'type' key."""
    opt = _port_options(opt)
    cls = ARCH_REGISTRY.get(opt.pop("type"))
    return cls(**opt)


__all__ = [
    "AppMotionCompFormer", "AutoEncoder", "AutoEncoderMSDecoder",
    "DCNv2Pack", "DenseMotionNetwork", "Encoder", "FuseFeatBlock",
    "Generator", "GumbelQuantizer", "KPDetector", "MSGenerator",
    "ModulatedDeformConvPack", "MotionEstimator", "MultiheadAttention",
    "ResidualBlockNoBN", "TransformerLayer", "Upsample", "VGG19Features",
    "VGGFeatureExtractor", "VQAutoEncoder", "VQGANDiscriminator",
    "VectorQuantizer", "build_network", "flow_warp", "make_layer",
    "resize_flow", "scaled_conv_kernel_init", "trunc_normal_init",
]
