"""Misc utilities of the entry points (the reference's
utils/misc.py:35-146)."""
from __future__ import annotations

import contextlib
import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and PyTorch's global generators
    (misc.py:35-41). The data pipeline draws frames and flips from the
    first two."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def sizeof_fmt(size: float, suffix: str = "B") -> str:
    """A byte count in binary units, e.g. '1.5 GB'."""
    for unit in ["", "K", "M", "G", "T", "P", "E", "Z"]:
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"


def strict_float32(device) -> torch.device:
    """``device`` as a torch device. On a card, TF32 is switched off for
    cuDNN convolutions and CUDA matmuls (process-wide), so that float32
    work there is float32, as on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


@contextlib.contextmanager
def tf32(enable: bool):
    """TF32 on (or off) for cuDNN convolutions and CUDA matmuls inside the
    scope; the earlier settings come back after it."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = enable
    torch.backends.cuda.matmul.allow_tf32 = enable
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
