"""Training dataset of VoxCeleb-style per-video frame folders (the
reference's data/frames_dataset.py:68-176; the port's copy of the JAX
package's ``FramesMotionTransferDataset`` and ``build_dataset``).

Each item is two random sorted frames of one video as (source, driving),
flipped together (horizontally and in time), resized to ``gt_size`` and
normalized with mean/std 0.5 to RGB in [-1, 1]: HWC float32 numpy. Frames
and flips are drawn from numpy's and Python's global generators, as in the
JAX package. Reading frames needs OpenCV.
"""
from __future__ import annotations

import glob
import os
from os import path as osp
from typing import Any, Dict

import numpy as np

from ..utils.img_util import _cv2, img2arr, imread
from ..utils.registry import DATASET_REGISTRY
from .transforms import augment_video


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] != size or img.shape[1] != size:
        cv2 = _cv2("resizing a frame")
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return img


@DATASET_REGISTRY.register()
class FramesMotionTransferDataset:
    """Training pairs: each video is a folder of frames under
    ``root_dir/train`` (``root_dir/test`` when ``is_train`` is false), or
    directly under ``root_dir``. With ``id_sampling`` one item per identity
    (the name before '#'), whose video is drawn at random."""

    def __init__(self, opt: Dict[str, Any]):
        self.opt = opt
        self.root_dir = opt["root_dir"]
        self.gt_size = int(opt.get("gt_size", 256))
        self.mean = opt.get("mean", [0.5] * 3)[0]
        self.std = opt.get("std", [0.5] * 3)[0]
        self.id_sampling = bool(opt.get("id_sampling", False))
        self.is_train = bool(opt.get("is_train", True))
        self.use_hflip = bool(opt.get("use_hflip", True))
        self.use_time_flip = bool(opt.get("use_time_flip", True))

        train_dir = osp.join(self.root_dir, "train")
        if osp.exists(train_dir):
            if self.id_sampling:
                videos = sorted({osp.basename(v).split("#")[0]
                                 for v in os.listdir(train_dir)})
            else:
                videos = sorted(os.listdir(train_dir))
            test_videos = sorted(os.listdir(osp.join(self.root_dir, "test")))
            self.root_dir = osp.join(self.root_dir,
                                     "train" if self.is_train else "test")
            self.videos = videos if self.is_train else test_videos
        else:
            self.videos = sorted(os.listdir(self.root_dir))

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.videos[idx]
        if self.is_train and self.id_sampling:
            candidates = glob.glob(osp.join(self.root_dir, name + "*"))
            path = np.random.choice(candidates)
        else:
            path = osp.join(self.root_dir, name)

        frames = sorted(glob.glob(path + "/*.png")) or sorted(
            glob.glob(path + "/*.jpg"))
        frame_idx = np.sort(np.random.choice(len(frames), replace=True,
                                             size=2))
        clip = [imread(frames[i], float32=True) for i in frame_idx]  # BGR
        clip = augment_video(clip, hflip=self.use_hflip, rotation=False,
                             time_flip=self.use_time_flip)
        clip = [_resize(f, self.gt_size) for f in clip]
        source = img2arr(clip[0], bgr2rgb=True, mean=self.mean, std=self.std)
        driving = img2arr(clip[1], bgr2rgb=True, mean=self.mean,
                          std=self.std)
        return {"source": source.astype(np.float32),
                "driving": driving.astype(np.float32)}


def build_dataset(opt: Dict[str, Any]):
    """The dataset class named by ``opt['type']``, built on a copy of
    ``opt``."""
    opt = dict(opt)
    return DATASET_REGISTRY.get(opt["type"])(opt)
