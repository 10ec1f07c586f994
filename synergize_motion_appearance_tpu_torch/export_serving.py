"""Export a serving artifact of the reenactment pipeline (counterpart of
the JAX package's tools/export_serving.py; the layout is in serving.py).

Builds the networks of a config YAML, with the checkpoints its ``path:``
entries name, wraps them in the inference pipeline with the given
options, and exports its stages and weights to a directory that
``demo --from_export`` serves:

    python -m synergize_motion_appearance_tpu_torch.export_serving \
        --config options/test.yml --out art/ --relative --adapt_scale \
        --fast --frame_batch 16 [--cpu]

The artifact runs on the device it is exported on: the card unless
``--cpu``.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    """Export; returns the artifact directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--frame_batch", type=int, default=16)
    p.add_argument("--relative", action="store_true")
    p.add_argument("--adapt_scale", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="bf16 compute, uint8 frames to and from the device, "
                        "I420 fetch, keypoint inputs downsampled on the host")
    p.add_argument("--platforms", default=None,
                   help="the one device to export for, cpu or cuda "
                        "(default: cuda, or cpu with --cpu)")
    p.add_argument("--cpu", action="store_true")
    opt = p.parse_args(argv)

    device = "cpu" if opt.cpu else "cuda"
    if opt.platforms:
        platforms = opt.platforms.split(",")
        if len(platforms) != 1:
            raise ValueError(
                f"--platforms {opt.platforms}: an artifact is exported for "
                f"one device; multi-platform artifacts are not ported yet "
                f"(ROADMAP.md, queue 1, item 5)")
        if platforms[0] not in ("cpu", "cuda"):
            raise ValueError(f"--platforms {opt.platforms}: want cpu or cuda")
        if opt.cpu and platforms[0] != "cpu":
            raise ValueError(f"--cpu contradicts --platforms {opt.platforms}")
        device = platforms[0]

    import torch

    from .demo import build_and_load
    from .inference import ReenactmentPipeline
    from .serving import export_pipeline
    from .utils.options import load_yaml

    net_g, motion_estimator = build_and_load(load_yaml(opt.config), device)
    pipeline = ReenactmentPipeline(
        net_g, motion_estimator, relative=opt.relative,
        adapt_scale=opt.adapt_scale, frame_batch=opt.frame_batch,
        compute_dtype=(torch.bfloat16 if (opt.bf16 or opt.fast)
                       else torch.float32),
        u8_io=opt.fast, yuv420_io=opt.fast, host_kp_downsample=opt.fast,
        device=device)
    export_pipeline(pipeline, opt.out)
    total = sum(os.path.getsize(os.path.join(opt.out, f))
                for f in os.listdir(opt.out))
    print(f"Exported serving artifact to {opt.out} ({total / 1e6:.1f} MB, "
          f"platforms=[{device}])")
    return opt.out


if __name__ == "__main__":
    main()
