"""Metric dispatch (the reference's metrics/__init__.py:14-24). PSNR, SSIM
and L1 are ported; the JAX package's other metrics (FID, LPIPS, AED, AKD,
id-similarity, pose) are not yet, and asking for one raises a
RuntimeError that says so."""
from typing import Any, Dict

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_l1, calculate_psnr, calculate_ssim

__all__ = ["calculate_l1", "calculate_metric", "calculate_psnr",
           "calculate_ssim"]


def calculate_metric(data: Dict[str, Any], opt: Dict[str, Any]):
    """The metric ``opt['type']`` on ``data``'s keyword arguments, with
    the rest of ``opt`` as options."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    try:
        fn = METRIC_REGISTRY.get(metric_type)
    except KeyError:
        raise RuntimeError(
            f"metric {metric_type} is not yet ported to the PyTorch "
            f"package (ported: {METRIC_REGISTRY.keys()})") from None
    return fn(**data, **opt)
