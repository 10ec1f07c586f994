"""Checkpoints of a training run (the port's counterpart of the JAX
package's training/checkpoint.py, with ``torch.save`` in place of orbax;
the reference's base_model.py:170-296).

One file per saved iteration, ``<ckpt_dir>/iter_<step>``, holds everything
``weights.load_train_state`` fills in a ``Trainer``: the epoch and the
step, the weights and BatchNorm statistics of G, M and D, the VGG19
weights of the perceptual loss, the EMA of G, and the three Adam states
(count and moments). A file ``latest`` names the newest. A state carried
over from the JAX package is saved and resumed like any other.
"""
from __future__ import annotations

import os
from os import path as osp
from typing import Dict, Optional

import torch

_NETS = ("net_g", "motion_estimator", "net_d", "vgg")
_OPTS = ("opt_g", "opt_m", "opt_d")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_checkpoint(ckpt_dir: str, trainer, epoch: int = 0) -> str:
    """Write ``trainer``'s state to ``ckpt_dir/iter_<step>`` and point
    ``latest`` at it; returns the file's path."""
    st = trainer.state
    ckpt = {"epoch": int(epoch), "step": int(st.step),
            "ema_g": _cpu(st.ema_g)}
    for name in _NETS:
        ckpt[name] = _cpu(getattr(trainer, name).state_dict())
    for name in _OPTS:
        o = getattr(st, name)
        ckpt[name] = {"count": int(o.count), "mu": _cpu(o.mu),
                      "nu": _cpu(o.nu)}
    ckpt_dir = osp.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(ckpt_dir, f"iter_{st.step}")
    torch.save(ckpt, path + ".tmp")
    os.replace(path + ".tmp", path)  # a crash never leaves half a file
    with open(osp.join(ckpt_dir, "latest"), "w") as f:
        f.write(f"iter_{st.step}\n")
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint ``latest`` names, or None."""
    marker = osp.join(ckpt_dir, "latest")
    if not osp.exists(marker):
        return None
    with open(marker) as f:
        path = osp.join(ckpt_dir, f.read().strip())
    return path if osp.exists(path) else None


def _checked(saved: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor],
             what: str, device) -> Dict[str, torch.Tensor]:
    """``saved`` on ``device`` after checking its names and shapes against
    ``like``'s, strictly."""
    if sorted(saved) != sorted(like):
        missing = sorted(set(like) - set(saved))
        extra = sorted(set(saved) - set(like))
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected "
                       f"{extra[:5]}")
    for k, v in saved.items():
        if v.shape != like[k].shape:
            raise ValueError(f"{what}.{k}: saved {tuple(v.shape)}, want "
                             f"{tuple(like[k].shape)}")
    return {k: v.to(device, copy=True) for k, v in saved.items()}


def restore_checkpoint(path: str, trainer) -> int:
    """Load the checkpoint at ``path`` into ``trainer`` (strict about names
    and shapes, as the reference's load, base_model.py:202-234); returns
    the epoch it was saved in."""
    from .trainer import AdamState, TrainState

    ckpt = torch.load(osp.abspath(path), map_location="cpu",
                      weights_only=True)
    for name in _NETS:
        getattr(trainer, name).load_state_dict(ckpt[name], strict=True)
    trainer.reset_optimizers(ckpt["step"])  # refreshes the VGG cast too
    dev = trainer.device
    params = {"opt_g": trainer.net_g, "opt_m": trainer.motion_estimator,
              "opt_d": trainer.net_d}
    adam = {}
    for name in _OPTS:
        like = dict(params[name].named_parameters())
        o = ckpt[name]
        adam[name] = AdamState(int(o["count"]),
                               _checked(o["mu"], like, f"{name}.mu", dev),
                               _checked(o["nu"], like, f"{name}.nu", dev))
    trainer.state = TrainState(
        step=int(ckpt["step"]),
        ema_g=_checked(ckpt["ema_g"], dict(trainer.net_g.named_parameters()),
                       "ema_g", dev),
        **adam)
    return int(ckpt["epoch"])
