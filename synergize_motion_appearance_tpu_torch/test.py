"""Frame-pair evaluation entry point of the port (counterpart of the JAX
package's test.py; the reference's basicsr/test.py:51-85 and
AppMotionCompModel.nondist_validation, appmotioncomp_model.py:463-570).

    python -m synergize_motion_appearance_tpu_torch.test \
        -opt options/test.yml [--device cpu]

For each dataset of the option file (a pairs list), each pair goes
through the motion estimator and the generator's inference forward, one
pair at a time in float32; the visual/result/source/driving PNGs are
written under the visualization path (``val.save_img``, default true),
PSNR, SSIM and L1 are averaged over the pairs, and the other metrics of
``val.metrics`` score those PNG directories. ``main`` parses the
arguments and the option file; ``run(opt)`` evaluates from an option
dict whose paths are derived, so a caller without a YAML reader passes
one built in Python through ``utils.options.derive_paths``.
"""
from __future__ import annotations

import argparse
from os import path as osp
from typing import Any, Dict

import numpy as np

PER_IMAGE_METRICS = ("psnr", "ssim", "l1")


def directory_metric(mname: str, mopt: Dict[str, Any], vis_dir: str,
                     cross_id: bool = False, device="cuda"):
    """A metric of the PNG directories under ``vis_dir``, its network on
    ``device``: FID between source and result, LPIPS between result and
    driving, the others between a ground truth (driving; source for AED
    and id-similarity in cross-identity runs) and result
    (test.py:86-106)."""
    from .metrics import calculate_metric

    if mname == "fid":
        data = dict(paths=[osp.join(vis_dir, "source"),
                           osp.join(vis_dir, "result")])
    elif mname == "lpips":
        data = dict(path1=osp.join(vis_dir, "result"),
                    path2=osp.join(vis_dir, "driving"))
    else:
        gt_dir = ("source" if cross_id and mname in ("face_aed",
                                                     "id_similarity")
                  else "driving")
        data = dict(path_gt=osp.join(vis_dir, gt_dir),
                    path_generated=osp.join(vis_dir, "result"))
    return calculate_metric(dict(data, device=device), mopt)


def finish_results(results: Dict[str, float], count: int,
                   metrics_opt: Dict[str, Any], vis_dir: str,
                   cross_id: bool, device, logger) -> Dict[str, float]:
    """Average the per-image metrics over ``count`` images, score the
    directory metrics, add l1_255 and log each."""
    for mname, mopt in metrics_opt.items():
        if mname in PER_IMAGE_METRICS:
            results[mname] /= max(count, 1)
        else:
            results[mname] = directory_metric(mname, mopt, vis_dir,
                                              cross_id, device)
    if "l1" in results:
        results["l1_255"] = results["l1"] / 255.0
    for mname, v in results.items():
        logger.info(f"  # {mname}: {v:.4f}")
    return results


def save_quad(vis_dir: str, img_name: str, visual, result, source,
              driving) -> None:
    """The four PNGs of one generated frame (BGR uint8)."""
    from .utils.img_util import imwrite

    for sub, suffix, img in (("visual", "v", visual), ("result", "r", result),
                             ("source", "s", source),
                             ("driving", "d", driving)):
        imwrite(img, osp.join(vis_dir, sub, f"{img_name}_{suffix}.png"))


def run(opt: Dict[str, Any], device="cuda") -> Dict[str, Dict[str, float]]:
    """Evaluate the networks of ``opt`` (paths derived, ``is_train``
    false) on each of its datasets on ``device``; returns each dataset's
    metrics by name."""
    import torch

    from .data import build_dataset
    from .demo import build_and_load
    from .metrics import calculate_metric
    from .utils.img_util import arr2img
    from .utils.logger import get_root_logger
    from .utils.misc import strict_float32
    from .utils.options import make_exp_dirs

    make_exp_dirs(opt)
    logger = get_root_logger()
    device = strict_float32(device)
    net_g, motion_estimator = build_and_load(opt, device)
    net_g.eval()
    motion_estimator.eval()

    vis_root = opt["path"]["visualization"]
    val_opt = opt.get("val", {}) or {}
    metrics_opt = val_opt.get("metrics") or {}
    save_img = val_opt.get("save_img", True)

    def to_device(a):
        return torch.from_numpy(a[None]).permute(0, 3, 1, 2).to(device)

    all_results = {}
    for ds_name, ds_opt in (opt.get("datasets") or {}).items():
        ds_opt["is_train"] = False
        dataset = build_dataset(ds_opt)
        name = ds_opt.get("name", ds_name)
        vis_dir = osp.join(vis_root, name)
        logger.info(f"Testing {name}: {len(dataset)} pairs")
        results = {m: 0.0 for m in metrics_opt}
        for idx in range(len(dataset)):
            item = dataset[idx]
            source, driving = to_device(item["source"]), to_device(
                item["driving"])
            with torch.no_grad():
                dense_motion = motion_estimator(driving, source)
                out = net_g(source, dense_motion, w=val_opt.get("w", 1),
                            inference=True)["out"]
            result = out.permute(0, 2, 3, 1).float().cpu().numpy()

            result_img = arr2img(result, rgb2bgr=True)
            gt_img = arr2img(item["driving"], rgb2bgr=True)
            src_img = arr2img(item["source"], rgb2bgr=True)
            if save_img:
                visual = np.concatenate((src_img, gt_img, result_img),
                                        axis=1)
                save_quad(vis_dir, item["frame_name"], visual, result_img,
                          src_img, gt_img)
            for mname, mopt in metrics_opt.items():
                if mname in PER_IMAGE_METRICS:
                    results[mname] += calculate_metric(
                        dict(img1=result_img, img2=gt_img), mopt)
        all_results[name] = finish_results(
            results, len(dataset), metrics_opt, vis_dir,
            bool(val_opt.get("cross_id")), device, logger)
    return all_results


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on (default cuda)")
    args = parser.parse_args(argv)

    from .utils.options import parse

    return run(parse(args.opt, is_train=False), device=args.device)


if __name__ == "__main__":
    main()
