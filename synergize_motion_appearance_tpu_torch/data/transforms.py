"""Clip-consistent augmentation (the reference's data/transforms.py:146-214;
the port's copy of the JAX package's data/transforms.py). Host-side numpy,
run in the input pipeline's threads."""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def augment_video(imgs: List[np.ndarray], hflip: bool = True,
                  rotation: bool = True, time_flip: bool = False,
                  return_status: bool = False,
                  rng: Optional[random.Random] = None):
    """The same flip / rot90 / time flip applied to every frame of the
    clip, each drawn with probability 1/2 from ``rng`` (Python's global
    generator by default), in this order."""
    r = rng or random
    do_hflip = hflip and r.random() < 0.5
    do_vflip = rotation and r.random() < 0.5
    do_rot90 = rotation and r.random() < 0.5
    do_tflip = time_flip and r.random() < 0.5

    clip = list(imgs)
    if do_hflip:
        clip = [np.ascontiguousarray(img[:, ::-1]) for img in clip]
    if do_vflip:
        clip = [np.ascontiguousarray(img[::-1]) for img in clip]
    if do_rot90:
        clip = [np.ascontiguousarray(img.transpose(1, 0, 2)) for img in clip]
    if do_tflip:
        clip = clip[::-1]
    if return_status:
        return clip, (do_hflip, do_vflip, do_rot90, do_tflip)
    return clip
