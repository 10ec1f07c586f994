"""Datasets of VoxCeleb-style per-video frame folders (the reference's
data/frames_dataset.py; the port's copy of the JAX package's
data/frames_dataset.py).

``FramesMotionTransferDataset`` (training, :68-176): each item is two
random sorted frames of one video as (source, driving), flipped together
(horizontally and in time), resized to ``gt_size`` and normalized with
mean/std 0.5 to RGB in [-1, 1]: HWC float32 numpy. Frames and flips are
drawn from numpy's and Python's global generators, as in the JAX package.

The evaluation datasets read a CSV pairs list with the standard library's
``csv`` (the JAX package reads it with pandas, to the same records):
``FramesMotionTransferTestDataset_CrossID_videopair_anchor`` (:178-306)
gives a source image, a whole driving video and its anchor frame;
``FramesMotionTransferTestDataset_PairsList`` (:308-399) a source and a
driving frame. Reading frames needs OpenCV.
"""
from __future__ import annotations

import csv
import glob
import os
from os import path as osp
from typing import Any, Dict, List

import numpy as np

from ..utils.img_util import _cv2, img2arr, imread, read_video_frames
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


def read_pairs(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV pairs list as dicts of strings, by header."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class _PairsDataset:
    def __init__(self, opt: Dict[str, Any]):
        self.opt = opt
        self.root_dir = opt["root_dir"]
        self.gt_size = int(opt.get("gt_size", 256))
        self.mean = opt.get("mean", [0.5] * 3)[0]
        self.std = opt.get("std", [0.5] * 3)[0]
        self.pairs = read_pairs(opt["pairs_list"])

    def __len__(self) -> int:
        return len(self.pairs)

    def _image(self, path: str) -> np.ndarray:
        """An image file (or the first frame of a folder) as normalized
        RGB at ``gt_size``."""
        if osp.isdir(path):
            path = osp.join(path, sorted(os.listdir(path))[0])
        img = _resize(imread(path, float32=True), self.gt_size)
        return img2arr(img, bgr2rgb=True, mean=self.mean,
                       std=self.std).astype(np.float32)


@DATASET_REGISTRY.register()
class FramesMotionTransferTestDataset_CrossID_videopair_anchor(
        _PairsDataset):
    """CSV columns source, driving (a video file or a frame folder) and
    optionally anchor_idx: the source, every driving frame and the
    anchor."""

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.pairs[idx]
        frames_rgb, _ = read_video_frames(
            osp.join(self.root_dir, rec["driving"]),
            size=(self.gt_size, self.gt_size))
        driving = [img2arr(f.astype(np.float32) / 255.0, bgr2rgb=False,
                           mean=self.mean, std=self.std)
                   for f in frames_rgb]
        return {
            "source": self._image(osp.join(self.root_dir, rec["source"])),
            "driving_video": np.stack(driving).astype(np.float32),
            "anchor_idx": int(rec.get("anchor_idx") or 0),
            "video_name": osp.splitext(osp.basename(rec["driving"]))[0],
            "driving_name_list": [f"{i:07d}"
                                  for i in range(len(frames_rgb))],
        }


@DATASET_REGISTRY.register()
class FramesMotionTransferTestDataset_PairsList(_PairsDataset):
    """CSV columns source and driving, two image files: one pair of
    frames per item, named '<source stem>_<driving stem>'."""

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.pairs[idx]
        stem = [osp.splitext(osp.basename(rec[k]))[0]
                for k in ("source", "driving")]
        return {
            "source": self._image(osp.join(self.root_dir, rec["source"])),
            "driving": self._image(osp.join(self.root_dir, rec["driving"])),
            "frame_name": f"{stem[0]}_{stem[1]}",
        }


def build_dataset(opt: Dict[str, Any]):
    """The dataset class named by ``opt['type']``, built on a copy of
    ``opt``."""
    opt = dict(opt)
    return DATASET_REGISTRY.get(opt["type"])(opt)
