"""Logging: the root logger, the per-iteration message logger with its ETA,
TensorBoard and wandb. The reference's utils/logger.py:10-169; the port's
copy of the JAX package's utils/logger.py. In a process group only rank 0
logs below ERROR and writes the log file."""
from __future__ import annotations

import datetime
import logging
import time
from typing import Any, Dict, Optional

initialized_loggers = {}


def get_root_logger(logger_name: str = "samt",
                    log_level: int = logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The named logger, to the console and, on its first call, to
    ``log_file``; on a rank other than 0 it logs errors only, to the
    console."""
    from ..parallel import is_master

    logger = logging.getLogger(logger_name)
    if logger_name in initialized_loggers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    if not is_master():
        logger.setLevel(logging.ERROR)
    else:
        logger.setLevel(log_level)
        if log_file is not None:
            fh = logging.FileHandler(log_file, "a")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    initialized_loggers[logger_name] = True
    return logger


class MessageLogger:
    """Formatted per-iteration console/TensorBoard logging with an ETA
    (logger.py:10-74)."""

    def __init__(self, opt: Dict[str, Any], start_iter: int = 1,
                 tb_logger=None):
        self.exp_name = opt.get("name", "exp")
        self.start_iter = start_iter
        self.max_iters = opt.get("train", {}).get("total_iter", 0)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: Dict[str, Any]):
        log_vars = dict(log_vars)
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", [])

        message = (f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        message += ",".join(f"{lr:.3e}" for lr in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(
                current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(max(eta_sec, 0))))
            message += (f"[eta: {eta_str}, time (data): "
                        f"{iter_time:.3f} ({data_time:.3f})] ")

        for k, v in log_vars.items():
            v = float(v)
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A TensorBoard writer, or None when none is installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir=log_dir)


def init_wandb_logger(opt) -> None:
    """wandb is not ported: warns (on rank 0) when an option file asks for
    it (``logger.wandb.project``) and does nothing."""
    from ..parallel import is_master

    if not is_master():
        return
    project = ((opt.get("logger") or {}).get("wandb") or {}).get("project")
    if project:
        get_root_logger().warning(
            f"wandb logging (project {project}) is not ported; skipped.")


def get_env_info() -> str:
    """The versions of the package, torch and CUDA, the device and the
    world size."""
    import torch

    from .. import __version__
    from ..parallel import get_dist_info

    cuda = torch.cuda.is_available()
    device = (f"{torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}" if cuda else "cpu")
    return (f"\nsynergize_motion_appearance_tpu_torch {__version__}"
            f"\n\ttorch {torch.__version__}"
            f"\n\tcuda {torch.version.cuda}"
            f"\n\tdevice {device}"
            f"\n\tworld size {get_dist_info()[1]}")
