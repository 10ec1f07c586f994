"""Model-based metrics: FID, LPIPS, AED, AKD, id-similarity and pose
(counterpart of the JAX package's metrics/external.py; the reference's
metrics/pytorch_fid/fid_score.py:231-264, cmp_lpips.py:11-47,
extract.py:59-102, cmp_id_similarity.py:43-64 and
norm_pose/cmp_pose_accuracy.py).

FID, LPIPS and AED run the port's own backbones (inception.py, lpips.py,
openface.py) on ``device`` ("cuda" unless the caller asks for "cpu"), in
float32, given their weight files. AKD, id-similarity and pose wrap
third-party face models (face_alignment, insightface, mediapipe) and raise
a RuntimeError that names the package when it is absent.

Weights are found as in the JAX package: the variables
SAMT_INCEPTION_WEIGHTS, SAMT_LPIPS_WEIGHTS, SAMT_OPENFACE_WEIGHTS and
SAMT_FACE_LANDMARKER_TASK name a file; otherwise $SAMT_WEIGHTS_DIR
(default ~/.cache/samt_weights) is searched for
pt_inception-2015-12-05-6726825d.pth or inception.npz, lpips_vgg.npz,
openface.pth or openface.npz. A torch file loads by the backbone's torch
names; an .npz is the JAX package's converted tree
(tools/convert_metric_weights.py). A missing file raises a RuntimeError
that names it.
"""
from __future__ import annotations

import os
from os import path as osp
from typing import Callable, List, Optional

import numpy as np

from ..utils.misc import strict_float32
from ..utils.registry import METRIC_REGISTRY


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Frechet distance between two gaussians (fid_score.py's math)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = np.atleast_2d(linalg.sqrtm(sigma1.dot(sigma2)))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray):
    """Mean and covariance of (N, D) features."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def _list_images(d: str) -> List[str]:
    exts = (".png", ".jpg", ".jpeg")
    return sorted(osp.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(exts))


def _require(module: str, what: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise RuntimeError(
            f"Metric '{what}' needs the optional dependency '{module}' "
            f"(not available in this environment). PSNR/SSIM/L1 run "
            f"everywhere; FID/LPIPS/AED run natively given weight files."
        ) from e


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _weights_dir() -> str:
    return os.environ.get("SAMT_WEIGHTS_DIR",
                          osp.expanduser("~/.cache/samt_weights"))


def _find_weights(env_var: str, candidates: List[str]) -> Optional[str]:
    p = os.environ.get(env_var)
    if p:
        if not osp.exists(p):
            raise RuntimeError(f"{env_var}={p} does not exist")
        return p
    for name in candidates:
        c = osp.join(_weights_dir(), name)
        if osp.exists(c):
            return c
    return None


def _missing(what: str, env_var: str, names: List[str],
             extra: str = "") -> RuntimeError:
    return RuntimeError(
        f"Metric '{what}' needs its backbone weights. Set {env_var} or "
        f"place one of {names} in {_weights_dir()} "
        f"(SAMT_WEIGHTS_DIR). Convert torch checkpoints with "
        f"tools/convert_metric_weights.py.{extra}")


def _load_state_dict(path: str, from_npz: Callable):
    """A torch state_dict from a torch file, or from the JAX package's
    converted ``.npz`` through ``from_npz``."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return from_npz({k: f[k] for k in f.files})
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


INCEPTION_FILES = ["pt_inception-2015-12-05-6726825d.pth", "inception.npz",
                   "pt_inception.pth"]
LPIPS_FILES = ["lpips_vgg.npz", "lpips_vgg.pth"]
OPENFACE_FILES = ["openface.pth", "openface.npz"]


def inception_net(device="cuda"):
    """FIDInceptionV3 with the weights weight discovery finds."""
    from .inception import inception_state_dict, load_inception

    wpath = _find_weights("SAMT_INCEPTION_WEIGHTS", INCEPTION_FILES)
    if wpath is None:
        raise _missing("fid", "SAMT_INCEPTION_WEIGHTS", INCEPTION_FILES[:2])
    return load_inception(_load_state_dict(
        wpath, inception_state_dict)).to(strict_float32(device))


def lpips_net(device="cuda"):
    """LPIPSVgg with the weights weight discovery finds (an .npz that
    holds both the VGG16 backbone and the lin heads)."""
    from .lpips import LPIPSVgg, lpips_state_dict

    wpath = _find_weights("SAMT_LPIPS_WEIGHTS", LPIPS_FILES)
    if wpath is None:
        raise _missing("lpips", "SAMT_LPIPS_WEIGHTS", LPIPS_FILES)
    if not wpath.endswith(".npz"):
        raise RuntimeError(
            "LPIPS .pth needs both the vgg16 backbone and the lin heads — "
            "merge them into lpips_vgg.npz with "
            "tools/convert_metric_weights.py --lpips <vgg16.pth> <lins.pth>")
    net = LPIPSVgg()
    net.load_state_dict(_load_state_dict(wpath, lpips_state_dict),
                        strict=True)
    return net.eval().to(strict_float32(device))


def openface_net(device="cuda"):
    """OpenFaceNet with the weights weight discovery finds."""
    from .openface import OpenFaceNet, openface_state_dict

    wpath = _find_weights("SAMT_OPENFACE_WEIGHTS", OPENFACE_FILES)
    if wpath is None:
        raise _missing("aed", "SAMT_OPENFACE_WEIGHTS", OPENFACE_FILES)
    net = OpenFaceNet()
    net.load_state_dict(_load_state_dict(wpath, openface_state_dict),
                        strict=True)
    return net.eval().to(strict_float32(device))


# ---------------------------------------------------------------------------
# image files
# ---------------------------------------------------------------------------

def _imread_rgb01(path: str) -> np.ndarray:
    from ..utils.img_util import _cv2

    cv2 = _cv2("reading metric images")
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img[..., ::-1].astype(np.float32) / 255.0


def _resize_antialias01(img: np.ndarray, size) -> np.ndarray:
    """skimage.transform.resize's anti-aliased downscale on a float [0, 1]
    HWC image (the reference's extract.py:47): a gaussian prefilter with
    sigma = (factor - 1) / 2 in mode 'mirror', then half-pixel-centre
    bilinear sampling. OpenCV's INTER_LINEAR alone differs on 256 -> 96."""
    from scipy.ndimage import gaussian_filter

    from ..utils.img_util import _cv2

    h, w = img.shape[:2]
    out_w, out_h = size
    sigma_h = max(0.0, ((h / out_h) - 1.0) / 2.0)
    sigma_w = max(0.0, ((w / out_w) - 1.0) / 2.0)
    if sigma_h > 0 or sigma_w > 0:
        img = gaussian_filter(img, (sigma_h, sigma_w, 0), mode="mirror")
    cv2 = _cv2("resizing faces")
    return cv2.resize(np.ascontiguousarray(img), size,
                      interpolation=cv2.INTER_LINEAR)


def _assert_paired_dirs(path_gt: str, path_generated: str, what: str):
    """The two directories' sorted image lists, which must pair up file
    for file by stem less its one-letter role suffix (X_r with X_d or
    X_s, extract.py:67-101)."""
    f1, f2 = _list_images(path_gt), _list_images(path_generated)
    if len(f1) != len(f2):
        raise RuntimeError(
            f"{what}: frame-count mismatch between {path_gt} "
            f"({len(f1)}) and {path_generated} ({len(f2)})")
    for a, b in zip(f1, f2):
        sa = osp.splitext(osp.basename(a))[0][:-1]
        sb = osp.splitext(osp.basename(b))[0][:-1]
        if sa != sb:
            raise RuntimeError(
                f"{what}: unpaired frames '{osp.basename(a)}' vs "
                f"'{osp.basename(b)}'")
    return f1, f2


def _batched(fn, images: List[np.ndarray], batch_size: int, device
             ) -> np.ndarray:
    """``fn`` over HWC images in NCHW batches on ``device``; float32
    numpy out."""
    import torch

    outs = []
    for lo in range(0, len(images), batch_size):
        batch = torch.from_numpy(np.stack(images[lo:lo + batch_size]))
        outs.append(fn(batch.permute(0, 3, 1, 2).to(device)).float().cpu()
                    .numpy())
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# FID, LPIPS, AED (the port's backbones)
# ---------------------------------------------------------------------------

@METRIC_REGISTRY.register(name="calculate_fid")
def calculate_fid(paths, batch_size: int = 32, device="cuda",
                  **kwargs) -> float:
    """FID between two image directories: InceptionV3 pool3 features in
    batches of 32 (fid_score.py:249-264)."""
    from .inception import extract_features

    net = inception_net(device)
    stats = []
    for d in paths:
        files = _list_images(d)
        if not files:
            raise RuntimeError(f"FID: no images in {d}")
        feats = _batched(lambda b: extract_features(net, b),
                         [_imread_rgb01(f) for f in files], batch_size,
                         device)
        stats.append(activation_statistics(feats.astype(np.float64)))
    return frechet_distance(stats[0][0], stats[0][1], stats[1][0],
                            stats[1][1])


def _lpips_pairs(path1: str, path2: str):
    """cmp_lpips.py:30-35: path2's file is ``name[:-6] + '_d.png'`` when
    it exists, else the same name."""
    pairs = []
    for f in sorted(os.listdir(path1)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        alt = f[:-6] + "_d.png"
        second = alt if osp.exists(osp.join(path2, alt)) else f
        pairs.append((osp.join(path1, f), osp.join(path2, second)))
    return pairs


@METRIC_REGISTRY.register(name="calculate_lpips")
def calculate_lpips(path1, path2, batch_size: int = 16, device="cuda",
                    **kwargs) -> float:
    """Mean LPIPS(vgg) over paired files (cmp_lpips.py:11-47), images
    read as x / 127.5 - 1."""
    import torch

    from .lpips import lpips_distance

    net = lpips_net(device)
    pairs = _lpips_pairs(path1, path2)
    if not pairs:
        raise RuntimeError(f"LPIPS: no images in {path1}")
    dists = []
    for lo in range(0, len(pairs), batch_size):
        chunk = pairs[lo:lo + batch_size]
        a, b = (torch.from_numpy(
            np.stack([_imread_rgb01(p[i]) for p in chunk]) * 2.0 - 1.0
        ).permute(0, 3, 1, 2).to(device) for i in (0, 1))
        with torch.no_grad():
            dists.append(lpips_distance(net, a, b).float().cpu().numpy())
    return float(np.mean(np.concatenate(dists)))


def _openface_embed_dir(net, d: str, device, batch_size: int = 32
                        ) -> np.ndarray:
    from .openface import embed_faces

    files = _list_images(d)
    if not files:
        raise RuntimeError(f"AED: no images in {d}")
    # extract.py:45-47: RGB -> BGR, skimage resize to 96, float [0, 1]
    imgs = [_resize_antialias01(_imread_rgb01(f)[..., ::-1], (96, 96))
            for f in files]
    return _batched(lambda b: embed_faces(net, b), imgs, batch_size, device)


@METRIC_REGISTRY.register(name="calculate_aed")
def calculate_aed(path_gt, path_generated, device="cuda", **kwargs
                  ) -> float:
    """Mean squared L2 distance of OpenFace's 128-d identity embeddings
    between paired driving and generated frames (extract.py's
    cmp_face_aed)."""
    _assert_paired_dirs(path_gt, path_generated, "AED")
    net = openface_net(device)
    e1 = _openface_embed_dir(net, path_gt, device)
    e2 = _openface_embed_dir(net, path_generated, device)
    return float(np.mean(np.sum((e1 - e2) ** 2, axis=1)))


# ---------------------------------------------------------------------------
# AKD, id-similarity, pose (third-party face models)
# ---------------------------------------------------------------------------

@METRIC_REGISTRY.register(name="calculate_akd")
def calculate_akd(path_gt, path_generated, **kwargs) -> float:
    """Mean absolute difference of face_alignment's 68 landmarks
    (extract.py's cmp_face_akd)."""
    _assert_paired_dirs(path_gt, path_generated, "AKD")
    fa_mod = _require("face_alignment", "akd")
    fa = fa_mod.FaceAlignment(fa_mod.LandmarksType.TWO_D, flip_input=False)

    def _landmarks(d):
        out = {}
        for f in _list_images(d):
            kp = fa.get_landmarks((_imread_rgb01(f) * 255).astype(np.uint8))
            out[osp.basename(f)] = None if kp is None else kp[0]
        return out

    l1, l2 = _landmarks(path_gt), _landmarks(path_generated)
    scores = [np.mean(np.abs(v1 - v2)) for (_, v1), (_, v2)
              in zip(sorted(l1.items()), sorted(l2.items()))
              if v1 is not None and v2 is not None]
    if not scores:
        raise RuntimeError("AKD: no faces detected in either directory")
    return float(np.mean(scores))


@METRIC_REGISTRY.register(name="calculate_id_similarity")
def calculate_id_similarity(path_gt, path_generated,
                            cross_id: bool = False, **kwargs) -> float:
    """Cosine similarity of insightface antelopev2 embeddings of paired
    frames (cmp_id_similarity.py:43-64)."""
    _assert_paired_dirs(path_gt, path_generated, "ID-similarity")
    insightface = _require("insightface", "id_similarity")
    app = insightface.app.FaceAnalysis(name="antelopev2")
    app.prepare(ctx_id=-1)

    def _embed(d):
        out = []
        for f in _list_images(d):
            img = (_imread_rgb01(f)[..., ::-1] * 255).astype(np.uint8)
            faces = app.get(img)
            out.append(None if not faces else faces[0].normed_embedding)
        return out

    sims = [float(np.dot(a, b)) for a, b in
            zip(_embed(path_gt), _embed(path_generated))
            if a is not None and b is not None]
    if not sims:
        raise RuntimeError("ID-similarity: no faces detected")
    return float(np.mean(sims))


def _pose_angles_dir(d: str, landmarker) -> List[Optional[np.ndarray]]:
    """Per-image euler angles from mediapipe's facial transformation
    matrices (mp_utils_refine.py:40-95, then pose_util)."""
    import mediapipe as mp

    from .pose_util import matrix_to_euler_and_translation

    out: List[Optional[np.ndarray]] = []
    for f in _list_images(d):
        rgb = (_imread_rgb01(f) * 255).astype(np.uint8)
        res = landmarker.detect(
            mp.Image(image_format=mp.ImageFormat.SRGB, data=rgb))
        if len(res.facial_transformation_matrixes) != 1:
            out.append(None)
            continue
        euler, _ = matrix_to_euler_and_translation(
            np.asarray(res.facial_transformation_matrixes[0]))
        out.append(euler)
    return out


@METRIC_REGISTRY.register(name="calculate_pose_accuracy")
@METRIC_REGISTRY.register(name="calculate_pose_distance")
def calculate_pose_accuracy(path_gt, path_generated, **kwargs) -> float:
    """L1 distance of mediapipe face-landmarker euler angles
    (norm_pose/cmp_pose_accuracy.py:40-61); the landmarker's .task file is
    found like the backbones' weights."""
    _require("mediapipe", "pose_accuracy")
    from mediapipe.tasks import python as mp_python
    from mediapipe.tasks.python import vision

    names = ["face_landmarker_v2_with_blendshapes.task",
             "face_landmarker.task"]
    task = _find_weights("SAMT_FACE_LANDMARKER_TASK", names)
    if task is None:
        raise _missing(
            "pose_accuracy", "SAMT_FACE_LANDMARKER_TASK", names[:1],
            " (mediapipe face-landmarker task blob; the reference ships "
            "it in .MISSING_LARGE_BLOBS)")
    landmarker = vision.FaceLandmarker.create_from_options(
        vision.FaceLandmarkerOptions(
            base_options=mp_python.BaseOptions(model_asset_path=task),
            output_facial_transformation_matrixes=True, num_faces=1))
    a1 = _pose_angles_dir(path_gt, landmarker)
    a2 = _pose_angles_dir(path_generated, landmarker)
    scores = [float(np.mean(np.abs(x - y))) for x, y in zip(a1, a2)
              if x is not None and y is not None]
    if not scores:
        raise RuntimeError("pose_accuracy: no faces detected")
    return float(np.mean(scores))
