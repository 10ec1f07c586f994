"""Checkpoints of a training run (the port's counterpart of the JAX
package's training/checkpoint.py, with ``torch.save`` in place of orbax;
the reference's base_model.py:170-296).

One file per saved iteration, ``<ckpt_dir>/iter_<step>``, holds everything
``weights.load_train_state`` fills in a ``Trainer``: the epoch and the
step, the weights and BatchNorm statistics of G, M and D, the VGG19
weights of the perceptual loss, the EMA of G, and the three Adam states
(count and moments). A file ``latest`` names the newest. A state carried
over from the JAX package is saved and resumed like any other.

Trained weights of one network for inference (the reference's
``net_g_<iter>.pth`` with a param key, base_model.py:236-263) are written
by ``export_params`` and read by ``load_variables``, which also reads the
``.npz`` that tools/convert_reference_checkpoint.py writes.
"""
from __future__ import annotations

import os
from os import path as osp
from typing import Any, Dict, Optional

import numpy as np
import torch

_NETS = ("net_g", "motion_estimator", "net_d", "vgg")
_OPTS = ("opt_g", "opt_m", "opt_d")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_checkpoint(ckpt_dir: str, trainer, epoch: int = 0) -> str:
    """Write ``trainer``'s state to ``ckpt_dir/iter_<step>`` and point
    ``latest`` at it; returns the file's path. In a process group only
    rank 0 writes (master_only, dist_util.py:74-82); the others return
    ''."""
    from ..parallel import is_master

    if not is_master():
        return ""
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


def export_params(path: str, state_dict: Dict[str, torch.Tensor],
                  param_key: str = "params") -> None:
    """Write one network's state_dict as ``{param_key: state_dict}``, the
    reference's inference file (net_g_<iter>.pth), which
    ``load_variables`` reads."""
    path = osp.abspath(path)
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.save({param_key: _cpu(state_dict)}, path)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _pick(restored: Dict[str, Any], param_key: str):
    """``restored[param_key]``, else ``restored['params']`` (the
    params_ema -> params fallback of base_model.py:247-252), else
    ``restored`` itself."""
    if param_key in restored:
        return restored[param_key]
    if "params" in restored:
        return restored["params"]
    return restored


def load_variables(path: str, param_key: str = "params",
                   net_cfg: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, torch.Tensor]:
    """One network's trained weights as a reference-named state_dict,
    which the port's module of that network loads with ``strict=True``.

    Reads a torch file (``{param_key: state_dict}``, falling back to
    ``params``, or a bare state_dict) or the ``.npz`` of flax variables
    that tools/convert_reference_checkpoint.py writes ('/'-joined keys),
    which goes through ``weights``' bridge for the network config
    ``net_cfg`` (the motion estimator's BatchNorm statistics ride along;
    ``{"type": "VGG19Features"}`` reads the ``.npz`` of
    tools/convert_vgg_weights.py). An orbax directory needs JAX and
    raises."""
    path = osp.abspath(path)
    if osp.isdir(path):
        raise RuntimeError(
            f"{path} is an orbax checkpoint directory, which needs JAX to "
            f"read; convert the reference .pth with "
            f"tools/convert_reference_checkpoint.py to an .npz, or load the "
            f"torch file itself")
    if path.endswith(".npz"):
        from ..weights import (motion_estimator_state_dict, net_g_state_dict,
                               vgg_state_dict)

        if net_cfg is None:
            raise ValueError(f"loading {path} needs the network's config "
                             f"(net_cfg)")
        with np.load(path) as f:
            restored = _unflatten({k: f[k] for k in f.files})
        variables = {"params": _pick(restored, param_key)}
        if "batch_stats" in restored:
            variables["batch_stats"] = restored["batch_stats"]
        if net_cfg["type"] == "VGG19Features":
            return vgg_state_dict(variables["params"])
        if net_cfg["type"] == "Motion_Estimator_keypoint_aware":
            return motion_estimator_state_dict(variables, net_cfg)
        return net_g_state_dict(variables, net_cfg)
    restored = torch.load(path, map_location="cpu", weights_only=True)
    return dict(_pick(restored, param_key))


# the '/'-joined params of VGG19Features in the .npz of
# tools/convert_vgg_weights.py: its 13 convs, through relu5_1
_VGG_KEYS = {f"conv{i}/Conv_0/{leaf}" for i in range(13)
             for leaf in ("kernel", "bias")}


def load_vgg_weights(path: str) -> Dict[str, torch.Tensor]:
    """The perceptual pyramid's VGG19 named by ``train.vgg_weights``, as
    the state_dict of ``models.VGG19Features``: the ``.npz`` of
    tools/convert_vgg_weights.py, or a torch file in VGG19Features' names
    (torchvision's ``features.<i>``). An absent file raises a RuntimeError,
    a tree other than VGG19Features' a ValueError; each names the path."""
    if not osp.exists(path):
        raise RuntimeError(
            f"train.vgg_weights={path} does not exist. Convert torchvision's "
            f"VGG19 with tools/convert_vgg_weights.py --src vgg19.pth --dst "
            f"<file>.npz, or remove the key to train against a random VGG.")
    if path.endswith(".npz"):
        with np.load(path) as f:
            tree = _pick(_unflatten({k: f[k] for k in f.files}), "params")
        got = set(_flat_keys(tree))
        if got != _VGG_KEYS:
            raise ValueError(
                f"train.vgg_weights={path}: param tree does not match "
                f"VGG19Features (missing {sorted(_VGG_KEYS - got)}, "
                f"unexpected {sorted(got - _VGG_KEYS)})")
    return load_variables(path, net_cfg={"type": "VGG19Features"})


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_keys(v, key)
        else:
            yield key
