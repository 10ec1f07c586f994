"""Image <-> array converters, image files and videos (the reference's
utils/img_util.py:13-172; the port's copy of the JAX package's
utils/img_util.py). Frames are NHWC / HWC numpy arrays here: the data
pipeline runs on the host, and the trainer moves batches to the device.

``grad_layer`` runs in torch on its input's device.

OpenCV and imageio are imported when present; a call that needs one that
is not raises an ImportError that names it. Videos are read and written
with imageio first and OpenCV when imageio has no backend for the file.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except ImportError:  # pragma: no cover - OpenCV is absent
    cv2 = None

try:
    import imageio
except ImportError:  # pragma: no cover - imageio is absent
    imageio = None


def _cv2(what: str):
    if cv2 is None:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not "
                          f"installed")
    return cv2


def img2arr(img: np.ndarray, bgr2rgb: bool = True,
            mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """HWC uint8 or float [0, 1] image -> HWC float32 RGB normalized
    ((x - mean) / std; the defaults give [-1, 1])."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if bgr2rgb and img.shape[2] == 3:
        img = img[..., ::-1]
    return (img - mean) / std


def arr2img(arr: np.ndarray, rgb2bgr: bool = True,
            min_max: Tuple[float, float] = (-1, 1)) -> np.ndarray:
    """NHWC (the first image) or HWC float RGB -> HWC uint8, BGR by
    default (tensor2img, img_util.py:42-98)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if rgb2bgr and arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    return (arr * 255.0).round().astype(np.uint8)


def imread(path: str, float32: bool = False) -> np.ndarray:
    """An image file as BGR HWC (OpenCV's convention); float32 in [0, 1]
    when asked."""
    img = _cv2("imread").imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True):
    """Write a BGR uint8 image, creating its directory
    (img_util.py:139-155)."""
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    if not _cv2("imwrite").imwrite(file_path, img):
        raise IOError(f"Failed to write image: {file_path}")


def imfrombytes(content: bytes, float32: bool = False) -> np.ndarray:
    """Encoded image bytes -> BGR HWC image (img_util.py:118-136)."""
    img = _cv2("imfrombytes").imdecode(np.frombuffer(content, np.uint8),
                                       cv2.IMREAD_COLOR)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def mimsave(frames: Sequence[np.ndarray], file_path: str, fps: int = 25):
    """Write RGB uint8 frames as a video or gif (img_util.py:157-172):
    with imageio, or with OpenCV's mp4v writer when imageio fails (no
    backend for the format, or imageio absent)."""
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    frames = list(frames)
    if imageio is not None:
        try:
            imageio.mimsave(file_path, frames, fps=fps)
            return
        except Exception:  # each backend raises its own errors; use cv2
            pass
    cv2_ = _cv2("mimsave without an imageio backend for this file")
    h, w = frames[0].shape[:2]
    writer = cv2_.VideoWriter(file_path, cv2_.VideoWriter_fourcc(*"mp4v"),
                              fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cv2.VideoWriter failed to open {file_path}")
    for f in frames:
        writer.write(np.ascontiguousarray(np.asarray(f)[..., ::-1]))
    writer.release()


def _read_with_imageio(path: str) -> Tuple[List[np.ndarray], float]:
    reader = imageio.get_reader(path)
    fps = float(reader.get_meta_data().get("fps", 25.0))
    frames = []
    try:
        for im in reader:
            frames.append(np.asarray(im)[..., :3])
    except RuntimeError:  # a truncated stream ends the frames it gave
        pass
    try:
        reader.close()
    except Exception:  # closing a reader that failed midway may raise
        pass
    if not frames:
        raise ValueError("imageio decoded zero frames")
    return frames, fps


def _read_with_cv2(path: str) -> Tuple[List[np.ndarray], float]:
    cap = _cv2("reading a video").VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1].copy())  # BGR -> RGB
    cap.release()
    return frames, fps


def read_video_frames(path: str, size: Optional[Tuple[int, int]] = None
                      ) -> Tuple[List[np.ndarray], float]:
    """A video file (mp4, gif, ...) or a folder of frames -> (RGB uint8
    frames, fps); frames resized to ``size`` (w, h) when given. A folder
    reads at 25 fps (the reference's demo.py:166-178)."""
    if os.path.isdir(path):
        frames = [np.ascontiguousarray(imread(os.path.join(path, n))
                                       [..., ::-1])
                  for n in sorted(os.listdir(path))]
        fps = 25.0
    else:
        try:
            if imageio is None:
                raise ImportError("imageio is not installed")
            frames, fps = _read_with_imageio(path)
        except Exception:  # no imageio backend for the file: use cv2
            frames, fps = _read_with_cv2(path)
    if size is not None:
        cv2_ = _cv2("resizing video frames")
        frames = [cv2_.resize(f, size, interpolation=cv2_.INTER_LINEAR)
                  for f in frames]
    return frames, fps


def grad_layer(x: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude |sobel_x| + |sobel_y| of the channel mean,
    zero-padded (the reference's GradLayer, utils/img_util.py:254-294):
    (B, H, W, C) -> (B, H, W, 1) on the input's device. The nine taps are
    shifted windows summed in a fixed order, so each output pixel's value
    does not depend on the image around it beyond its 3x3 reach (a tile
    gives the same bits as the whole image)."""
    C = x.shape[-1]
    gray = x[..., 0]
    for c in range(1, C):
        gray = gray + x[..., c]
    gray = gray / C
    H, W = gray.shape[1:]
    p = F.pad(gray, (1, 1, 1, 1))

    def win(i, j):
        return p[:, i:i + H, j:j + W]

    gx = (win(0, 2) - win(0, 0)) + 2 * (win(1, 2) - win(1, 0)) + (
        win(2, 2) - win(2, 0))
    gy = (win(2, 0) - win(0, 0)) + 2 * (win(2, 1) - win(0, 1)) + (
        win(2, 2) - win(0, 2))
    return (gx.abs() + gy.abs())[..., None]


def show_feature_map(feat) -> np.ndarray:
    """A feature map's channel mean, min-max scaled to an (H, W) uint8
    image; (B, H, W, C) shows its first item (the reference's feature-map
    visualiser)."""
    f = (feat.detach().float().cpu().numpy() if torch.is_tensor(feat)
         else np.asarray(feat))
    if f.ndim == 4:
        f = f[0]
    m = f.mean(axis=-1)
    m = (m - m.min()) / (m.max() - m.min() + 1e-8)
    return (m * 255).astype(np.uint8)
