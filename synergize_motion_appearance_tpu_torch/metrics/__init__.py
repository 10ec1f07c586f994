"""Metric dispatch (the reference's metrics/__init__.py:14-24).

PSNR, SSIM and L1 are numpy. FID, LPIPS and AED run the port's own
backbones (``inception``, ``lpips``, ``openface``) given their weight
files; AKD, id-similarity and pose wrap third-party face models and raise
a RuntimeError when those are absent (``external``)."""
from typing import Any, Dict

from ..utils.registry import METRIC_REGISTRY
from . import external  # noqa: F401  (registers the model-based metrics)
from .psnr_ssim import calculate_l1, calculate_psnr, calculate_ssim

__all__ = ["calculate_l1", "calculate_metric", "calculate_psnr",
           "calculate_ssim"]


def calculate_metric(data: Dict[str, Any], opt: Dict[str, Any]):
    """The metric ``opt['type']`` on ``data``'s keyword arguments, with
    the rest of ``opt`` as options."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
