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
``--cpu``. ``--platforms cpu,cuda`` writes one artifact with programs
for both devices (``demo --from_export`` picks the card's, or the CPU's
with ``--cpu``); it needs a card, since ``torch.export`` traces the
card's programs only on one, and without a card it raises before
anything is written.
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
                   help="the devices to export for: cpu, cuda or cpu,cuda "
                        "(default: cuda, or cpu with --cpu)")
    p.add_argument("--cpu", action="store_true")
    opt = p.parse_args(argv)

    platforms = ["cpu" if opt.cpu else "cuda"]
    if opt.platforms:
        platforms = opt.platforms.split(",")
        if not set(platforms) <= {"cpu", "cuda"} or len(set(platforms)) \
                != len(platforms):
            raise ValueError(f"--platforms {opt.platforms}: want cpu, cuda "
                             f"or cpu,cuda")
        if opt.cpu and "cuda" in platforms:
            raise ValueError(f"--cpu contradicts --platforms {opt.platforms}")
    # the networks live on the card when its programs are exported
    device = "cuda" if "cuda" in platforms else "cpu"

    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--platforms {','.join(platforms)}: exporting "
                           f"the cuda programs needs a CUDA device, and "
                           f"there is none here")

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
    export_pipeline(pipeline, opt.out, platforms)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(opt.out) for f in files)
    print(f"Exported serving artifact to {opt.out} ({total / 1e6:.1f} MB, "
          f"platforms={platforms})")
    return opt.out


if __name__ == "__main__":
    main()
