"""Video reconstruction and cross-identity animation entry point of the
port (counterpart of the JAX package's animate.py; the reference's
basicsr/animate.py:49-83 and generate_video_image,
appmotioncomp_model.py:642-756).

    python -m synergize_motion_appearance_tpu_torch.animate \
        -opt <option file> [--frame_batch 8] [--device cpu]

For each CSV pair of each dataset the driving video is split at its
anchor frame and animated forward and backward from it
(``ReenactmentPipeline.animate_with_anchor``, bfloat16 as the JAX
pipeline's default), each frame's visual/result/source/driving PNGs are
written, and the result and visual videos; PSNR, SSIM and L1 are
averaged over the frames and the other metrics of ``val.metrics`` score
the PNG directories, as test.py does. ``run(opt)`` takes an option dict
whose paths are derived.
"""
from __future__ import annotations

import argparse
from os import path as osp
from typing import Any, Dict

import numpy as np


def run(opt: Dict[str, Any], device="cuda", frame_batch: int = 8
        ) -> Dict[str, Dict[str, float]]:
    """Animate every pair of every dataset of ``opt`` on ``device``;
    returns each dataset's metrics by name."""
    from .data import build_dataset
    from .demo import build_and_load
    from .inference import ReenactmentPipeline
    from .metrics import calculate_metric
    from .test import PER_IMAGE_METRICS, finish_results, save_quad
    from .utils.img_util import arr2img, mimsave
    from .utils.logger import get_root_logger
    from .utils.options import make_exp_dirs

    make_exp_dirs(opt)
    logger = get_root_logger()
    val_opt = opt.get("val", {}) or {}
    metrics_opt = val_opt.get("metrics") or {}
    vis_root = opt["path"]["visualization"]

    net_g, motion_estimator = build_and_load(opt, device)
    pipeline = ReenactmentPipeline(
        net_g, motion_estimator, relative=val_opt.get("relative", False),
        adapt_scale=val_opt.get("adapt_scale", False),
        frame_batch=frame_batch, w=val_opt.get("w", 1), device=device)

    all_results = {}
    for ds_name, ds_opt in (opt.get("datasets") or {}).items():
        ds_opt["is_train"] = False
        dataset = build_dataset(ds_opt)
        name = ds_opt.get("name", ds_name)
        vis_dir = osp.join(vis_root, name)
        results = {m: 0.0 for m in metrics_opt}
        count = 0
        for idx in range(len(dataset)):
            item = dataset[idx]
            source = item["source"][None]
            driving = item["driving_video"]
            preds = pipeline.animate_with_anchor(source, driving,
                                                 int(item["anchor_idx"]))
            src_img = arr2img(source, rgb2bgr=True)
            video_name = item["video_name"]
            pred_rgb, visual_rgb = [], []
            for i in range(preds.shape[0]):
                pred_img = arr2img(preds[i], rgb2bgr=True)
                drv_img = arr2img(driving[i], rgb2bgr=True)
                vis = np.concatenate((src_img, drv_img, pred_img), axis=1)
                save_quad(vis_dir,
                          f"{video_name}_{item['driving_name_list'][i]}",
                          vis, pred_img, src_img, drv_img)
                pred_rgb.append(pred_img[..., ::-1])
                visual_rgb.append(vis[..., ::-1])
                for mname, mopt in metrics_opt.items():
                    if mname in PER_IMAGE_METRICS:
                        results[mname] += calculate_metric(
                            dict(img1=pred_img, img2=drv_img), mopt)
                count += 1
            mimsave(pred_rgb, osp.join(vis_dir, "result_videos",
                                       f"{video_name}_r.mp4"))
            mimsave(visual_rgb, osp.join(vis_dir, "visual_videos",
                                         f"{video_name}_v.mp4"))
            logger.info(f"Animated {video_name}: {preds.shape[0]} frames")
        all_results[name] = finish_results(
            results, count, metrics_opt, vis_dir,
            bool(val_opt.get("cross_id")), device, logger)
    return all_results


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--frame_batch", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device to animate on (default cuda)")
    args = parser.parse_args(argv)

    from .utils.options import parse

    return run(parse(args.opt, is_train=False), device=args.device,
               frame_batch=args.frame_batch)


if __name__ == "__main__":
    main()
