"""Dataset path and frame-index helpers, the DUF downsample and the
inpainting masks (the reference's basicsr/data/data_util.py: read_img_seq
:13, frame indices :37, paired paths :89-257, gaussian kernel and DUF
downsample :259-308, brush-stroke and free-form masks :310-391; the port's
copy of the JAX package's data/data_util.py).

Images are NHWC, as in the JAX package: ``read_img_seq`` gives host numpy
frames, and ``duf_downsample`` runs in torch on its input's device.
OpenCV and PIL are imported by the functions that need them; without
them those raise a RuntimeError that names the package.
"""
from __future__ import annotations

import math
import os.path as osp
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.misc import require, scandir


def read_img_seq(path, require_mod_crop: bool = False, scale: int = 1
                 ) -> np.ndarray:
    """A folder of images (sorted) or a list of image paths as (T, H, W, C)
    float32 RGB in [0, 1], each cropped to a multiple of ``scale`` when
    ``require_mod_crop`` (data_util.py:13-34; NHWC, not torch NCHW)."""
    cv2 = require("cv2", "read_img_seq")
    paths = (list(path) if isinstance(path, (list, tuple))
             else sorted(scandir(path, full_path=True)))
    imgs = []
    for p in paths:
        img = cv2.imread(p).astype(np.float32) / 255.0
        if require_mod_crop:
            h, w = img.shape[:2]
            img = img[:h - h % scale, :w - w % scale]
        imgs.append(img[..., ::-1])  # BGR -> RGB
    return np.stack(imgs)


_FRAME_PADDING = ("replicate", "reflection", "reflection_circle", "circle")


def generate_frame_indices(crt_idx: int, max_frame_num: int,
                           num_frames: int,
                           padding: str = "reflection") -> List[int]:
    """The ``num_frames`` indices centred on ``crt_idx``, those past either
    end of ``max_frame_num`` frames replaced as ``padding`` says
    (data_util.py:37-88)."""
    assert num_frames % 2 == 1, "num_frames should be an odd number."
    if padding not in _FRAME_PADDING:
        raise ValueError(f"Wrong padding mode: {padding}.")
    last = max_frame_num - 1
    half = num_frames // 2
    out = []
    for i in range(crt_idx - half, crt_idx + half + 1):
        if i < 0:
            i = {"replicate": 0,
                 "reflection": -i,
                 "reflection_circle": crt_idx + half - i,
                 "circle": num_frames + i}[padding]
        elif i > last:
            i = {"replicate": last,
                 "reflection": 2 * last - i,
                 "reflection_circle": (crt_idx - half) - (i - last),
                 "circle": i - num_frames}[padding]
        out.append(i)
    return out


def _check_pair_args(folders, keys):
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError("folders/keys must be [input, gt] pairs, got "
                         f"{len(folders)} folders, {len(keys)} keys")


def _lmdb_keys(folder: str) -> List[str]:
    with open(osp.join(folder, "meta_info.txt")) as f:
        return [line.split(".")[0] for line in f]


def paired_paths_from_lmdb(folders: Sequence[str], keys: Sequence[str]):
    """[{in_key_path: k, gt_key_path: k}] over the sorted keys of two
    lmdbs' meta_info.txt, which must hold the same keys
    (data_util.py:89-145)."""
    _check_pair_args(folders, keys)
    (in_folder, gt_folder), (in_key, gt_key) = folders, keys
    if not (in_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(f"{in_key} and {gt_key} folders must both be "
                         f".lmdb, got {in_folder} and {gt_folder}")
    in_keys, gt_keys = _lmdb_keys(in_folder), _lmdb_keys(gt_folder)
    if set(in_keys) != set(gt_keys):
        raise ValueError(
            f"Keys in {in_key}_folder and {gt_key}_folder differ.")
    return [{f"{in_key}_path": k, f"{gt_key}_path": k}
            for k in sorted(in_keys)]


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl):
    """Pairs for the gt names listed (first word of each line) in
    ``meta_info_file``; the input's stem is ``filename_tmpl`` of the gt's
    (data_util.py:148-190)."""
    _check_pair_args(folders, keys)
    (in_folder, gt_folder), (in_key, gt_key) = folders, keys
    with open(meta_info_file) as f:
        gt_names = [line.split(" ")[0] for line in f]
    paths = []
    for gt_name in gt_names:
        stem, ext = osp.splitext(osp.basename(gt_name))
        paths.append({
            f"{in_key}_path": osp.join(
                in_folder, filename_tmpl.format(stem) + ext),
            f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_folder(folders, keys, filename_tmpl):
    """Pairs by scanning both folders: each gt file with the input named
    ``filename_tmpl`` of its stem (data_util.py:192-225)."""
    _check_pair_args(folders, keys)
    (in_folder, gt_folder), (in_key, gt_key) = folders, keys
    in_names = set(scandir(in_folder))
    gt_names = list(scandir(gt_folder))
    if len(in_names) != len(gt_names):
        raise ValueError(
            f"{in_key} and {gt_key} folders have different image counts: "
            f"{len(in_names)}, {len(gt_names)}.")
    paths = []
    for gt_name in gt_names:
        stem, ext = osp.splitext(osp.basename(gt_name))
        in_name = filename_tmpl.format(stem) + ext
        if in_name not in in_names:
            raise ValueError(f"{in_name} is not in {in_key}_paths.")
        paths.append({f"{in_key}_path": osp.join(in_folder, in_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def paths_from_folder(folder: str) -> List[str]:
    return [osp.join(folder, p) for p in scandir(folder)]


def paths_from_lmdb(folder: str) -> List[str]:
    if not folder.endswith(".lmdb"):
        raise ValueError(f"Folder {folder} should be in lmdb format.")
    return _lmdb_keys(folder)


def generate_gaussian_kernel(kernel_size: int = 13, sigma: float = 1.6
                             ) -> np.ndarray:
    """A (kernel_size, kernel_size) float64 Gaussian: scipy's
    gaussian_filter of a centred dirac (data_util.py:259-275)."""
    from scipy.ndimage import gaussian_filter

    dirac = np.zeros((kernel_size, kernel_size))
    dirac[kernel_size // 2, kernel_size // 2] = 1.0
    return gaussian_filter(dirac, sigma)


def duf_downsample(x, kernel_size: int = 13, scale: int = 4
                   ) -> torch.Tensor:
    """The DUF protocol's Gaussian downsample (data_util.py:277-308) of
    NHWC frames, (T, H, W, C) or (B, T, H, W, C), on their device: reflect
    pad by kernel_size // 2 + 2 * scale, blur with sigma 0.4 * scale
    (one depthwise convolution per channel) at stride ``scale``, crop 2
    pixels from each border."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Only scale (2, 3, 4) supported, got {scale}.")
    x = torch.as_tensor(x)
    squeeze = x.ndim == 4
    if squeeze:
        x = x[None]
    B, T, H, W, C = x.shape
    pad = kernel_size // 2 + scale * 2
    flat = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    flat = F.pad(flat, (pad, pad, pad, pad), mode="reflect")
    kern = torch.as_tensor(
        generate_gaussian_kernel(kernel_size, 0.4 * scale),
        dtype=x.dtype, device=x.device)
    out = F.conv2d(flat, kern[None, None].repeat(C, 1, 1, 1), stride=scale,
                   groups=C)
    out = out[:, :, 2:-2, 2:-2].permute(0, 2, 3, 1)
    out = out.reshape(B, T, *out.shape[1:])
    return out[0] if squeeze else out


def brush_stroke_mask(img, color=(255, 255, 255)):
    """One to three thick random brush strokes drawn onto the PIL image
    ``img`` (data_util.py:310-361; GatedConv's inpainting masks). Needs
    PIL."""
    require("PIL", "brush_stroke_mask")
    from PIL import Image, ImageDraw

    w, h = img.size
    radius = math.sqrt(h * h + w * w) / 8
    mean_angle = 2 * math.pi / 5
    angle_range = 2 * math.pi / 12
    mask = img if isinstance(img, Image.Image) else Image.new(
        "RGB", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for _ in range(np.random.randint(1, 4)):
        n = np.random.randint(8, 28)
        lo = mean_angle - np.random.uniform(0, angle_range)
        hi = mean_angle + np.random.uniform(0, angle_range)
        angles = [(2 * math.pi - np.random.uniform(lo, hi)) if i % 2 == 0
                  else np.random.uniform(lo, hi) for i in range(n)]
        pts = [(int(np.random.randint(0, w)),
                int(np.random.randint(0, h)))]
        for a in angles:
            r = np.clip(np.random.normal(radius, radius // 2),
                        0, 2 * radius)
            pts.append((int(np.clip(pts[-1][0] + r * math.cos(a), 0, w)),
                        int(np.clip(pts[-1][1] + r * math.sin(a), 0, h))))
        width = int(np.random.uniform(30, 70))
        draw.line(pts, fill=color, width=width)
        for px, py in pts:
            draw.ellipse((px - width // 2, py - width // 2,
                          px + width // 2, py + width // 2), fill=color)
    return mask


def random_ff_mask(shape, max_angle: int = 10, max_len: int = 100,
                   max_width: int = 70, times: int = 10) -> np.ndarray:
    """DeepFillv2's free-form mask (data_util.py:365-391): random-walk
    strokes of 1.0 on an (H, W) float32 mask of 0.0. Needs OpenCV."""
    cv2 = require("cv2", "random_ff_mask")
    h, w = shape[0], shape[1]
    mask = np.zeros((h, w), np.float32)
    for i in range(np.random.randint(times - 5, times)):
        x, y = np.random.randint(w), np.random.randint(h)
        for _ in range(1 + np.random.randint(5)):
            angle = 0.01 + np.random.randint(max_angle)
            if i % 2 == 0:
                angle = 2 * math.pi - angle
            length = 10 + np.random.randint(max_len - 20, max_len)
            brush = 5 + np.random.randint(max_width - 30, max_width)
            ex = int(x + length * math.sin(angle))
            ey = int(y + length * math.cos(angle))
            cv2.line(mask, (y, x), (ey, ex), 1.0, brush)
            x, y = ex, ey
    return mask
