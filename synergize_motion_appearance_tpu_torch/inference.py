"""Reenactment inference: keypoints, relative motion, dense motion and the
generator, in frame batches on one device or split across several; the
anchor-split animation of the demo and of animate.py, and the choice of
that anchor.

Counterpart of the JAX package's inference.py (``normalize_kp_jnp``,
``ReenactmentPipeline``, ``find_best_frame*``,
``build_pipeline_from_config``). The public API keeps its NHWC layout:
frames go in as (F, H, W, 3) uint8 or [-1, 1] float arrays and come out as
(F, H, W, 3) uint8 (``u8_io=True``) or float32 in [-1, 1]. Inside, tensors
are NCHW in ``compute_dtype`` (bfloat16 by default, as in the JAX package)
with keypoint math in float32. Entry points run on ``device`` ("cuda"
unless the caller asks for "cpu").
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .models import build_network
from .models.dense_motion import inv2x2
from .ops import convex_hull_area
from .ops.color import rgb_to_yuv420
from .ops.coords import antialias_downsample_host, blur_stride_u8
from .parallel import create_mesh
from .utils.img_util import _cv2
from .utils.misc import strict_float32, tf32


def normalize_kp(kp_source, kp_driving, kp_driving_initial,
                 adapt_movement_scale: bool = False,
                 use_relative_movement: bool = False,
                 use_relative_jacobian: bool = False):
    """Relative-motion keypoint normalization (reference demo.py:24-44),
    batched over driving frames; kp_source and kp_driving_initial have
    batch 1. The hull area stays on the device. Keypoints without
    Jacobians (a detector built with ``estimate_jacobian=False``) move by
    their values alone."""
    if adapt_movement_scale:
        source_area = convex_hull_area(kp_source["value"][0])
        driving_area = convex_hull_area(kp_driving_initial["value"][0])
        scale = torch.sqrt(source_area) / torch.sqrt(driving_area)
    else:
        scale = 1.0
    kp_new = dict(kp_driving)
    if use_relative_movement:
        diff = (kp_driving["value"] - kp_driving_initial["value"]) * scale
        kp_new["value"] = diff + kp_source["value"]
        if use_relative_jacobian and kp_driving.get("jacobian") is not None:
            jac_diff = kp_driving["jacobian"] @ inv2x2(
                kp_driving_initial["jacobian"].float())
            kp_new["jacobian"] = jac_diff @ kp_source["jacobian"]
    return kp_new


class _Bound(nn.Module):
    """``net`` itself, or its method ``method``, as this module's forward,
    so that ``torch.func.functional_call`` can run it on weights given as
    a dict. The module itself is called, not its forward, so its hooks
    run."""

    def __init__(self, net: nn.Module, method: Optional[str] = None):
        super().__init__()
        self.net = net
        self.method = method

    def forward(self, *args, **kwargs):
        fn = self.net if self.method is None else getattr(self.net,
                                                          self.method)
        return fn(*args, **kwargs)


def _apply(bound: _Bound, weights: Dict[str, torch.Tensor], *args,
           **kwargs):
    """``bound`` run with ``weights`` (its network's parameters and
    buffers by name) in place of the network's own."""
    return torch.func.functional_call(
        bound, {f"net.{k}": v for k, v in weights.items()}, args, kwargs)


def _moved(tree, device):
    """Every tensor of a nested dict / list / tuple on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moved(v, device) for v in tree)
    return tree


def net_weights(net: nn.Module) -> Dict[str, torch.Tensor]:
    """A network's parameters and buffers by name: what a stage takes as
    its weights."""
    return {**dict(net.named_parameters()), **dict(net.named_buffers())}


class ReenactmentPipeline:
    """Holds the two networks on ``device`` in ``compute_dtype`` and runs
    reenactment in frame batches of ``frame_batch``.

    The networks are moved, cast and put in eval mode in place. For
    float32 on a card, TF32 is switched off for cuDNN convolutions and
    CUDA matmuls (process-wide), so float32 means float32. In bfloat16
    the generator's motion pass runs in float32, as the JAX graph's type
    promotion runs it, and ``animate`` runs it at TF32 on a card.

    The work is three stages, as in the JAX package: ``_kp_impl``
    (keypoints of a batch of frames), ``_enc_impl`` (the source's encoder
    features, once per source) and ``_gen_impl`` (relative motion, dense
    motion and the generator for a frame batch). Each is a function of
    its weights, a dict of parameters and buffers by name
    (``net_weights``), and of its tensors, so ``serving.export_pipeline``
    exports the same bodies that ``animate`` runs here.

    The JAX package's options for a slow host link: ``yuv420_io`` (with
    ``u8_io``) fetches generated frames as packed I420 and converts them
    back to RGB on the host with OpenCV, which it needs;
    ``host_kp_downsample`` blurs and strides the frames to the keypoint
    detector's resolution on the host (OpenCV for uint8 frames, numpy for
    float ones) and sends those, in bfloat16.

    Frame parallelism (the JAX pipeline's ``mesh``): with ``mesh``, a list
    of devices (``parallel.create_mesh``; a device may repeat; without it,
    ``[device]``), the pipeline runs on the mesh's first device, the
    weights are copied once to each other device, and each padded frame
    batch's generation (``_gen_impl``) is split evenly across the devices,
    each running its chunk, with the frames gathered on the first device.
    The frames are independent given the source's keypoints, so the
    result is the one device's. ``frame_batch`` must divide by the mesh's
    length."""

    def __init__(self, net_g, motion_estimator, relative: bool = False,
                 adapt_scale: bool = False, frame_batch: int = 8,
                 w: float = 1.0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 u8_io: bool = False, host_kp_downsample: bool = False,
                 yuv420_io: bool = False, device="cuda", mesh=None):
        self.mesh = ([torch.device(device)] if mesh is None
                     else create_mesh(mesh))
        if frame_batch % len(self.mesh):
            raise ValueError(f"frame_batch {frame_batch} does not split "
                             f"evenly across {len(self.mesh)} devices")
        self.compute_dtype = compute_dtype or torch.float32
        self.device = self.mesh[0]
        if self.compute_dtype == torch.float32:
            strict_float32(self.device)
        self.net_g = net_g.to(self.device, self.compute_dtype).eval()
        self.motion_estimator = motion_estimator.to(
            self.device, self.compute_dtype).eval()
        self.relative = relative
        self.adapt_scale = adapt_scale
        self.frame_batch = frame_batch
        self.w = w
        self.u8_io = u8_io
        self.yuv420_io = yuv420_io and u8_io
        self.host_kp_downsample = host_kp_downsample
        self.kp_scale = (self.motion_estimator.kp_detector.scale_factor
                         if host_kp_downsample else 1.0)
        self.img_size = self.net_g.img_size
        self.g_weights = net_weights(self.net_g)
        self.m_weights = net_weights(self.motion_estimator)
        self._replicas = {self.device: (self.g_weights, self.m_weights)}
        for d in self.mesh:
            if d not in self._replicas:
                self._replicas[d] = (_moved(self.g_weights, d),
                                     _moved(self.m_weights, d))
        me = self.motion_estimator
        self._kp_net = _Bound(me, "estimate_kp")
        self._motion_net = _Bound(me, "estimate_motion_w_kp")
        self._enc_net = _Bound(self.net_g, "encode_source")
        self._gen_net = _Bound(self.net_g)

    # -------------------- stages --------------------

    def _normalize_in(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 or float frames -> (N, 3, H, W) in the model
        domain and ``compute_dtype``."""
        x = images.to(self.compute_dtype)
        if images.dtype == torch.uint8:
            x = x * (2.0 / 255.0) - 1.0
        return x.permute(0, 3, 1, 2).contiguous()

    def _kp_impl(self, m_weights, images, pre_downsampled: bool = False
                 ) -> Dict[str, torch.Tensor]:
        kp = _apply(self._kp_net, m_weights, self._normalize_in(images),
                    pre_downsampled)
        return {k: v.float() for k, v in kp.items()}  # kp math in f32

    def _enc_impl(self, g_weights, source):
        """The source's encoder features, once per source: {'latent',
        'feats': {resolution: feature}}."""
        return _apply(self._enc_net, g_weights, self._normalize_in(source))

    def _gen_impl(self, g_weights, m_weights, source, src_feats, kp_source,
                  kp_driving, kp_driving_initial) -> torch.Tensor:
        """source (1, H, W, 3) as given to ``animate``; keypoints in
        float32, kp_driving batched. Returns (F, H, W, 3) frames: uint8
        with ``u8_io`` (packed (F, H*3/2, W) I420 with ``yuv420_io``),
        else float32 in [-1, 1]."""
        source = self._normalize_in(source)
        F_ = kp_driving["value"].shape[0]
        kp_norm = normalize_kp(
            kp_source, kp_driving, kp_driving_initial,
            adapt_movement_scale=self.adapt_scale,
            use_relative_movement=self.relative,
            use_relative_jacobian=self.relative)
        dt = self.compute_dtype
        kp_norm = {k: v.to(dt) for k, v in kp_norm.items()}
        kp_src = {k: v.expand(F_, *v.shape[1:]).to(dt)
                  for k, v in kp_source.items()}
        # the batch-1 source is downsampled once and read by every frame
        dense_motion = _apply(self._motion_net, m_weights, kp_src, kp_norm,
                              source)
        out = _apply(self._gen_net, g_weights, source, dense_motion,
                     w=self.w, inference=True, source_feats=src_feats)["out"]
        out = out.permute(0, 2, 3, 1)
        if self.yuv420_io:
            return rgb_to_yuv420(out)
        if self.u8_io:
            out = torch.clamp(out.float(), -1.0, 1.0)
            return torch.round((out + 1.0) * 127.5).to(torch.uint8)
        return out.float()

    def _kp_fn(self, images, pre_downsampled: bool = False):
        return self._kp_impl(self.m_weights, self._to_device(images),
                             pre_downsampled)

    def _enc_fn(self, source):
        return self._enc_impl(self.g_weights, self._to_device(source))

    def _gen_fn(self, source, src_feats, kp_source, kp_driving, kp_initial):
        source = self._to_device(source)
        c = kp_driving["value"].shape[0] // len(self.mesh)
        outs = []
        for i, d in enumerate(self.mesh):  # queued on every device first
            g_w, m_w = self._replicas[d]
            chunk = {k: v[i * c:(i + 1) * c].to(d)
                     for k, v in kp_driving.items()}
            outs.append(self._gen_impl(
                g_w, m_w, *_moved((source, src_feats, kp_source), d), chunk,
                _moved(kp_initial, d)))
        return torch.cat([o.to(self.device) for o in outs])

    # -------------------- host orchestration --------------------

    def _to_device(self, images) -> torch.Tensor:
        """Frames (numpy or a tensor) as a tensor on the device."""
        if not isinstance(images, torch.Tensor):
            images = torch.as_tensor(np.ascontiguousarray(images))
        return images.to(self.device)

    def _host_kp_prep(self, frames_np) -> torch.Tensor:
        """uint8 or float frames -> normalized frames at the keypoint
        detector's resolution, bfloat16 on the host. uint8 frames blur in
        uint8 (within a level of the float path)."""
        f = np.asarray(frames_np)
        if f.dtype == np.uint8:
            small = (blur_stride_u8(f, self.kp_scale).astype(np.float32)
                     * (2.0 / 255.0) - 1.0)
        else:
            small = antialias_downsample_host(f, self.kp_scale)
        return torch.from_numpy(np.ascontiguousarray(small)).to(
            torch.bfloat16)

    def _kp_frames(self, frames_np) -> Dict[str, torch.Tensor]:
        """Keypoints of host frames, downsampled on the host when the
        pipeline says so."""
        if self.host_kp_downsample:
            return self._kp_fn(self._host_kp_prep(frames_np), True)
        return self._kp_fn(frames_np)

    @torch.no_grad()
    def estimate_kp(self, images) -> Dict[str, torch.Tensor]:
        """Keypoints (float32, on the device) of full-size frames."""
        return self._kp_fn(images)

    @torch.no_grad()
    def animate(self, source_np, driving_np) -> np.ndarray:
        """source: (1, H, W, 3); driving: (F, H, W, 3), uint8 or [-1, 1]
        float. Returns (F, H, W, 3) frames: uint8 with ``u8_io``, else
        float32 in [-1, 1]. The last frame batch is padded with copies of
        the last frame; the relative motion is taken against driving[0]."""
        n_frames = driving_np.shape[0]
        source = self._to_device(source_np)
        kp_source = self._kp_frames(source_np)
        src_feats = self._enc_fn(source)  # once per source

        fb = self.frame_batch
        outs = []
        kp_initial = None
        # A bfloat16 pipeline's float32 work (the motion pass, which the
        # JAX graph promotes to float32 and the TPU runs at its default
        # float32 precision, bf16 passes) takes TF32 on a card; a float32
        # pipeline stays in full float32.
        with tf32(self.compute_dtype != torch.float32):
            for s in range(0, n_frames, fb):
                chunk = np.asarray(driving_np[s:s + fb])
                n = chunk.shape[0]
                if n < fb:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], fb - n, axis=0)])
                kp_chunk = self._kp_frames(chunk)
                if kp_initial is None:  # kp of driving[0] (demo.py:115)
                    kp_initial = {k: v[:1] for k, v in kp_chunk.items()}
                outs.append(self._gen_fn(source, src_feats, kp_source,
                                         kp_chunk, kp_initial)[:n])
        out = torch.cat(outs).cpu().numpy()
        if self.yuv420_io:  # (F, H*3/2, W) I420 -> RGB on the host
            cv2 = _cv2("yuv420_io")
            return np.stack([cv2.cvtColor(p, cv2.COLOR_YUV2RGB_I420)
                             for p in out])
        return out

    def animate_with_anchor(self, source_np, driving_np,
                            anchor_idx: int) -> np.ndarray:
        """Forward from the anchor frame and backward from it to frame 0,
        stitched (the reference's demo.py:210-217): each half takes its
        relative motion against its own first frame, the anchor."""
        fwd = self.animate(source_np, driving_np[anchor_idx:])
        bwd = self.animate(source_np, driving_np[:anchor_idx + 1][::-1])
        return np.concatenate([bwd[::-1], fwd[1:]], axis=0)


def _to_rgb01(x: np.ndarray) -> np.ndarray:
    """Model-domain ([-1, 1] float) or uint8 frame(s) -> float [0, 1]."""
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return (np.asarray(x, np.float32) + 1.0) / 2.0


def _hull_normalized(kp: np.ndarray) -> np.ndarray:
    """Keypoints centred on their mean and divided by the square root of
    their convex hull's area (the reference's demo.py:74-101)."""
    from scipy.spatial import ConvexHull

    kp = kp - kp.mean(axis=0, keepdims=True)
    area = np.sqrt(ConvexHull(kp[:, :2]).volume)
    return kp / max(area, 1e-8)


def find_best_frame_fa(source_np, driving_np, cpu: bool = False) -> int:
    """The anchor by face_alignment's 68 landmarks, the reference's
    criterion (demo.py:74-101): the driving frame whose hull-normalized
    landmarks are nearest the source's (squared L2). A frame whose
    detection fails is skipped, as there."""
    import face_alignment
    from scipy.spatial import ConvexHull

    def normalize_kp(kp):
        kp = np.asarray(kp, np.float64).copy()
        kp = kp - kp.mean(axis=0, keepdims=True)
        kp[:, :2] = kp[:, :2] / np.sqrt(ConvexHull(kp[:, :2]).volume)
        return kp

    fa = face_alignment.FaceAlignment(
        face_alignment.LandmarksType.TWO_D, flip_input=True,
        device="cpu" if cpu else "cuda")
    landmarks = getattr(fa, "get_landmarks_from_image", None) \
        or fa.get_landmarks
    source = _to_rgb01(np.asarray(source_np))
    if source.ndim == 4:
        source = source[0]
    kp_source = normalize_kp(landmarks(255 * source)[0])
    norm, frame_num = float("inf"), 0
    for i in range(driving_np.shape[0]):
        try:
            kp_driving = normalize_kp(
                landmarks(255 * _to_rgb01(driving_np[i]))[0])
            new_norm = float(((kp_source - kp_driving) ** 2).sum())
            if new_norm < norm:
                norm, frame_num = new_norm, i
        except Exception as e:  # no face in this frame (reference :99)
            print(e)
    return frame_num


def find_best_frame_kp(pipeline: ReenactmentPipeline, source_np,
                       driving_np) -> int:
    """The anchor by the pipeline's own keypoints under the reference's
    hull-normalized criterion, for when face_alignment is absent: the
    first driving frame nearest the source. Keypoints are computed in
    chunks of the pipeline's frame batch, the last one padded."""
    kp_s = _hull_normalized(
        pipeline.estimate_kp(source_np)["value"][0].cpu().numpy())
    bs = int(pipeline.frame_batch)
    kps = []
    for s in range(0, driving_np.shape[0], bs):
        chunk = np.asarray(driving_np[s:s + bs])
        n = chunk.shape[0]
        if n < bs:  # a served pipeline takes batch 1 or frame_batch only
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
        kps.append(pipeline.estimate_kp(chunk)["value"][:n].cpu().numpy())
    kps = np.concatenate(kps)
    best, best_idx = float("inf"), 0
    for i in range(kps.shape[0]):
        n = float(((_hull_normalized(kps[i]) - kp_s) ** 2).sum())
        if n < best:
            best, best_idx = n, i
    return best_idx


def find_best_frame(source_np, driving_np,
                    pipeline: Optional[ReenactmentPipeline] = None,
                    cpu: bool = False) -> int:
    """The anchor by face_alignment when it works, else (given a
    pipeline) by the pipeline's keypoints: any failure of the
    face_alignment path (package absent, no face in the source, no card
    for it) falls back, as in the JAX package."""
    try:
        return find_best_frame_fa(source_np, driving_np, cpu=cpu)
    except Exception as e:
        if pipeline is None:
            raise
        print(f"find_best_frame: face_alignment path failed "
              f"({type(e).__name__}: {e}); using own-kp fallback")
        return find_best_frame_kp(pipeline, source_np, driving_np)


def build_pipeline_from_config(config: Dict[str, Any], g_state_dict,
                               m_state_dict, relative: bool = False,
                               adapt_scale: bool = False,
                               frame_batch: int = 8,
                               device="cuda") -> ReenactmentPipeline:
    """The two networks of ``config`` with the given state_dicts
    (``strict=True``) in a pipeline with its default options."""
    net_g = build_network(config["network_g"])
    motion_estimator = build_network(config["network_motion_estimator"])
    net_g.load_state_dict(g_state_dict, strict=True)
    motion_estimator.load_state_dict(m_state_dict, strict=True)
    return ReenactmentPipeline(net_g, motion_estimator, relative=relative,
                               adapt_scale=adapt_scale,
                               frame_batch=frame_batch, device=device)
