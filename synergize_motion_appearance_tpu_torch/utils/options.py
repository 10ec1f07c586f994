"""Option files of the training and test entry points (the reference's
utils/options.py:7-109; the port's copy of the JAX package's
utils/options.py).

``parse`` reads a YAML file (``load_yaml``) and derives the experiment
paths (``derive_paths``); a caller that already holds the option dict, as
``configs.py`` gives it, calls ``derive_paths`` alone and needs no YAML
reader. PyYAML is imported only by ``load_yaml``.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from os import path as osp
from typing import Any, Dict


def load_yaml(path: str) -> Dict[str, Any]:
    """An option file as nested dicts in the file's key order."""
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - PyYAML is absent
        raise ImportError(
            f"reading {path} needs PyYAML; without it, build the option "
            f"dict in Python and pass it through derive_paths") from e
    try:
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Loader

    class _Ordered(Loader):
        pass

    _Ordered.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG,
        lambda loader, node: OrderedDict(loader.construct_pairs(node)))
    with open(path) as f:
        return yaml.load(f, Loader=_Ordered)


def derive_paths(opt: Dict[str, Any], is_train: bool = True
                 ) -> Dict[str, Any]:
    """Tags the dataset phases and derives the experiment paths
    (options.py:32-88) in ``opt``, which it returns. A ``resume_state``
    reuses the resumed run's experiment directory."""
    opt["is_train"] = is_train
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]

    path_opt = opt.setdefault("path", {})
    save_root = path_opt.get("save_path", "./experiments")
    if path_opt.get("resume_state"):
        path_opt["resume_state"] = osp.abspath(path_opt["resume_state"])
        experiments_root = osp.dirname(osp.dirname(path_opt["resume_state"]))
        opt["name"] = osp.basename(experiments_root)
    else:
        experiments_root = osp.join(save_root, opt.get("name", "exp"))

    if is_train:
        path_opt["experiments_root"] = experiments_root
        path_opt["models"] = osp.join(experiments_root, "models")
        path_opt["training_states"] = osp.join(experiments_root,
                                               "training_states")
        path_opt["log"] = experiments_root
        path_opt["visualization"] = osp.join(experiments_root,
                                             "visualization")
    else:
        results_root = osp.join(save_root, "results", opt.get("name", "exp"))
        path_opt["results_root"] = results_root
        path_opt["log"] = results_root
        path_opt["visualization"] = osp.join(results_root, "visualization")
    return opt


def parse(opt_path: str, is_train: bool = True) -> Dict[str, Any]:
    """Read a training/test option file and derive its experiment paths."""
    return derive_paths(load_yaml(opt_path), is_train)


def dict2str(opt: Dict[str, Any], indent_level: int = 1) -> str:
    """Pretty-print an option dict (options.py:91-109)."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def make_exp_dirs(opt: Dict[str, Any]) -> None:
    """Create the experiment tree (utils/misc.py:61-75)."""
    keys = (("experiments_root", "models", "training_states",
             "visualization") if opt.get("is_train")
            else ("results_root", "visualization"))
    for key in keys:
        if opt["path"].get(key):
            os.makedirs(opt["path"][key], exist_ok=True)
