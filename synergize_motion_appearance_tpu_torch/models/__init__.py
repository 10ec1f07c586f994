"""Networks of the reenactment and training paths, and their registry.

``build_network({'type': ..., **kwargs})`` takes the same ``type`` strings
as the JAX package's, including the reference alias
``Motion_Estimator_keypoint_aware``.
"""
from typing import Any, Dict

from ..utils.registry import ARCH_REGISTRY
from .appmotion_former import AppMotionCompFormer
from .dense_motion import DenseMotionNetwork, MotionEstimator
from .keypoint_detector import KPDetector
from .transformer import MultiheadAttention, TransformerLayer
from .vgg import VGG19Features
from .vqgan import Encoder, Generator, VectorQuantizer, VQGANDiscriminator

for _cls in (KPDetector, DenseMotionNetwork, MotionEstimator,
             AppMotionCompFormer, VQGANDiscriminator):
    ARCH_REGISTRY.register(_cls)
# reference alias (archs/motion_estimator_arch.py:15)
ARCH_REGISTRY.register(MotionEstimator,
                       name="Motion_Estimator_keypoint_aware")


# keys of the JAX configs that the port does not take: switches fixed at
# the value every config uses, and the keys that choose the TPU's
# W-in-lanes layout (wl_*; the port's training forward always runs its
# decoder region on kernel K3, and inference never does)
_FIXED = {"with_position_emb": True, "warp_s_d_kp_query": True,
          "MRFA_motion_enc": True, "motion_codebook_split": True,
          "multiscale_feature_fusion": True, "app_codebook_split": True,
          "estimate_jacobian": True, "estimate_occlusion_map": True,
          "multi_mask": False, "quantizer_type": "nearest"}
_IGNORED = ("wl_decoder", "wl_train", "wl_xlr")


def _port_options(opt: Dict[str, Any]) -> Dict[str, Any]:
    """``opt`` (and its nested dicts) without the fixed and ignored keys;
    raises for a fixed switch set to its other value."""
    out = {}
    for key, value in opt.items():
        if key in _FIXED:
            if value != _FIXED[key]:
                raise NotImplementedError(
                    f"only {key}={_FIXED[key]} is ported")
        elif key not in _IGNORED:
            out[key] = (_port_options(value) if isinstance(value, dict)
                        else value)
    return out


def build_network(opt: Dict[str, Any]):
    """Instantiate a network from a config dict with a 'type' key."""
    opt = _port_options(opt)
    cls = ARCH_REGISTRY.get(opt.pop("type"))
    return cls(**opt)


__all__ = [
    "AppMotionCompFormer", "DenseMotionNetwork", "Encoder", "Generator",
    "KPDetector", "MotionEstimator", "MultiheadAttention",
    "TransformerLayer", "VGG19Features", "VQGANDiscriminator",
    "VectorQuantizer", "build_network",
]
