"""Misc utilities of the entry points (the reference's
utils/misc.py:35-146)."""
from __future__ import annotations

import contextlib
import importlib
import os
import random
import time
from os import path as osp
from typing import Generator

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and PyTorch's global generators
    (misc.py:35-41). The data pipeline draws frames and flips from the
    first two."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def require(package: str, what: str):
    """Import the optional ``package`` for ``what``; without it, raise a
    RuntimeError that names the package."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise RuntimeError(f"{what} needs {package}, which is not "
                           f"installed") from e


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """Make ``path``; an existing directory there is first renamed with a
    timestamp (misc.py:48-58)."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False) -> Generator[str, None, None]:
    """The files under ``dir_path`` (hidden ones skipped), relative to it
    unless ``full_path``, those ending in ``suffix`` (a string or a tuple)
    when it is given (misc.py:79-118)."""
    if suffix is not None and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                path = (entry.path if full_path
                        else osp.relpath(entry.path, root))
                if suffix is None or path.endswith(suffix):
                    yield path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path)

    return _scandir(dir_path)


def check_resume(opt: dict, resume_iter: int) -> None:
    """With ``path.resume_state`` set, point each ``network_*``'s
    ``pretrain_network_*`` path at its checkpoint of ``resume_iter``
    (misc.py:121-146)."""
    if not opt["path"].get("resume_state"):
        return
    for network in (k for k in list(opt) if k.startswith("network_")):
        name = network.replace("network_", "")
        opt["path"][f"pretrain_{network}"] = osp.join(
            opt["path"]["models"], f"net_{name}_{resume_iter}")
    print(f"Set pretrain paths to resume iter {resume_iter}")


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
