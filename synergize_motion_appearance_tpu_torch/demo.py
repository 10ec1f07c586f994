"""Inference CLI of the port (counterpart of the JAX package's demo.py; the
reference's basicsr/demo.py:136-249): animate a source portrait by a
driving video.

    python -m synergize_motion_appearance_tpu_torch.demo \
        --config options/test.yml --source_image source.png \
        --driving_video driving.mp4 --result_video result.mp4 [--cpu]

The flags are the JAX demo's. ``--from_export <dir>`` serves an
artifact of ``export_serving`` instead (serving.py): no network is built,
and the image size, frame batch and frame types are the artifact's.
Otherwise networks and checkpoint paths come from ``--config`` (``path.pretrain_network_g`` under ``param_key_g``, default
``params_ema``, and ``path.pretrain_network_motion_estimator`` under
``param_key_m``, default ``params``); without a path a network keeps
seeded random weights. float32 unless ``--bf16`` or ``--fast``; ``--fast``
also moves uint8 frames, fetches I420 and downsamples keypoint inputs on
the host. The card unless ``--cpu``.

``main`` is four steps that a caller can take one by one: decode the
files (``decode_inputs``, OpenCV and imageio), build the pipeline
(``build_and_load``), animate (``reenact``, arrays only) and encode
(``encode_outputs``).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def build_and_load(config: Dict[str, Any], device="cuda"):
    """(net_g, motion_estimator) of ``config`` on ``device``, each with the
    trained weights its ``path`` entry names, loaded ``strict=True``."""
    from .training.checkpoint import load_variables
    from .weights import seeded_nets

    net_g, motion_estimator = seeded_nets(config, 0)
    path_cfg = config.get("path", {}) or {}
    g_path = path_cfg.get("pretrain_network_g")
    m_path = path_cfg.get("pretrain_network_motion_estimator")
    if g_path:
        net_g.load_state_dict(load_variables(
            g_path, path_cfg.get("param_key_g", "params_ema"),
            config["network_g"]), strict=True)
    if m_path:
        # the BatchNorm running statistics are part of its trained weights
        motion_estimator.load_state_dict(load_variables(
            m_path, path_cfg.get("param_key_m", "params"),
            config["network_motion_estimator"]), strict=True)
    return net_g.to(device), motion_estimator.to(device)


def decode_inputs(source_image: str, driving_video: str, img_size: int
                  ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray], float]:
    """The source image and the driving video's frames resized to
    ``img_size``: (source (1, H, W, 3) and driving (F, H, W, 3) float32 RGB
    in [-1, 1], the driving frames as RGB uint8, the video's fps)
    (demo.py:165-185)."""
    from .utils.img_util import _cv2, img2arr, read_video_frames

    cv2 = _cv2("decoding the source image")
    source_bgr = cv2.imread(source_image, cv2.IMREAD_COLOR)
    if source_bgr is None:
        raise FileNotFoundError(source_image)
    source_bgr = cv2.resize(source_bgr, (img_size, img_size),
                            interpolation=cv2.INTER_LINEAR)
    source = img2arr(source_bgr.astype(np.float32) / 255.0,
                     bgr2rgb=True)[None]
    frames_rgb, fps = read_video_frames(driving_video,
                                        size=(img_size, img_size))
    driving = np.stack([img2arr(f.astype(np.float32) / 255.0, bgr2rgb=False)
                        for f in frames_rgb]).astype(np.float32)
    return source, driving, frames_rgb, fps


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8, as ``--fast`` feeds them."""
    return np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)


def reenact(pipeline, source: np.ndarray, driving: np.ndarray,
            anchor: Optional[int] = None) -> np.ndarray:
    """The driving video's motion on the source: one pass from frame 0,
    or with ``anchor`` forward and backward from that frame."""
    if anchor is None:
        return pipeline.animate(source, driving)
    return pipeline.animate_with_anchor(source, driving, anchor)


def encode_outputs(preds: np.ndarray, source: np.ndarray,
                   frames_rgb: List[np.ndarray], fps: float,
                   result_video: str, visual_video: Optional[str] = None
                   ) -> List[np.ndarray]:
    """Write the frames (and, given ``visual_video``, source | driving |
    result side by side); returns the result's RGB uint8 frames."""
    from .utils.img_util import arr2img, mimsave

    if preds.dtype == np.uint8:
        pred_imgs = list(preds)
    else:
        pred_imgs = [arr2img(p, rgb2bgr=False) for p in preds]
    mimsave(pred_imgs, result_video, fps=fps)
    if visual_video is not None:
        src_img = (source[0] if source.dtype == np.uint8
                   else arr2img(source, rgb2bgr=False))
        mimsave([np.concatenate((src_img, frames_rgb[i], pred_imgs[i]),
                                axis=1) for i in range(len(pred_imgs))],
                visual_video, fps=fps)
    return pred_imgs


def main(argv=None) -> np.ndarray:
    """Run the demo; returns the generated frames."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--from_export", default=None,
                        help="serve from an artifact directory of "
                             "export_serving (no --config needed)")
    parser.add_argument("--source_image", default="source.png")
    parser.add_argument("--driving_video", default="driving.mp4")
    parser.add_argument("--result_video", default="result.mp4")
    parser.add_argument("--visual_video", default=None)
    parser.add_argument("--relative", action="store_true")
    parser.add_argument("--adapt_scale", action="store_true")
    parser.add_argument("--find_best_frame", action="store_true")
    parser.add_argument("--best_frame", type=int, default=None)
    parser.add_argument("--frame_batch", type=int, default=8)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 inference (default float32)")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 compute, uint8 frames to and from the "
                             "device, I420 fetch, keypoint inputs "
                             "downsampled on the host")
    parser.add_argument("--audio", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    opt = parser.parse_args(argv)

    import torch

    from .inference import ReenactmentPipeline, find_best_frame
    from .utils.options import load_yaml

    device = "cpu" if opt.cpu else "cuda"
    if opt.from_export is not None:
        from .serving import load_serving_pipeline

        # the artifact's options stand in for the pipeline flags
        pipeline = load_serving_pipeline(opt.from_export, device)
        img_size, fast_io = pipeline.img_size, pipeline.u8_io
    else:
        if opt.config is None:
            parser.error("--config is required unless --from_export is set")
        config = load_yaml(opt.config)
        img_size = int(config["network_g"].get("img_size", 256))
        fast_io = opt.fast
    source, driving, frames_rgb, fps = decode_inputs(
        opt.source_image, opt.driving_video, img_size)
    if opt.from_export is None:
        net_g, motion_estimator = build_and_load(config, device)
        pipeline = ReenactmentPipeline(
            net_g, motion_estimator, relative=opt.relative,
            adapt_scale=opt.adapt_scale, frame_batch=opt.frame_batch,
            compute_dtype=(torch.bfloat16 if (opt.bf16 or opt.fast)
                           else torch.float32),
            u8_io=opt.fast, yuv420_io=opt.fast, host_kp_downsample=opt.fast,
            device=device)
    if fast_io:  # uint8 to the device; normalized there
        source, driving = to_uint8(source), to_uint8(driving)

    anchor = None
    if opt.find_best_frame or opt.best_frame is not None:
        anchor = (opt.best_frame if opt.best_frame is not None
                  else find_best_frame(source, driving, pipeline=pipeline,
                                       cpu=opt.cpu))
        print(f"Best frame: {anchor}")
    preds = reenact(pipeline, source, driving, anchor)
    encode_outputs(preds, source, frames_rgb, fps, opt.result_video,
                   opt.visual_video)
    print(f"Saved {len(preds)} frames to {opt.result_video}")
    if opt.audio:
        _mux_audio(opt.result_video, opt.driving_video)
    return preds


def _mux_audio(result_video: str, driving_video: str):
    """Copy the driving video's audio track into the result
    (demo.py:232-249) with the ffmpeg program, when there is one."""
    if shutil.which("ffmpeg") is None:
        print("ffmpeg not found; skipping audio mux.")
        return
    with tempfile.NamedTemporaryFile(
            suffix=os.path.splitext(result_video)[1], delete=False) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", result_video, "-i", driving_video,
             "-map", "0:v", "-map", "1:a?", "-c", "copy", tmp_path],
            check=True, capture_output=True)
        shutil.move(tmp_path, result_video)
    except subprocess.CalledProcessError:
        print("Failed to copy audio (driving video may have no audio).")
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


if __name__ == "__main__":
    main()
