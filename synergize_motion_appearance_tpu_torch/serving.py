"""Exported serving artifacts for the reenactment pipeline (counterpart of
the JAX package's serving.py).

``export_pipeline`` runs ``torch.export`` on the live pipeline's three
stage functions (``ReenactmentPipeline._kp_impl``, ``_enc_impl``,
``_gen_impl``) at static shapes and saves the programs with the networks'
weights beside them. ``load_serving_pipeline`` loads them back and runs
``animate`` without building the networks or running their Python code:
every stage is a deserialized program of ATen operators and the port's
``samt`` operators, the generation stage calling kernel K1
(``torch.ops.samt.fused_attention_packed``) on a card.

Artifact layout (one directory):
    manifest.json   the pipeline's options, the devices ("platforms"), the
                    format version
    kp1.pt2         keypoint stage, batch 1 (the source, driving[0])
    kpN.pt2         keypoint stage, batch frame_batch (driving chunks)
    enc.pt2         source encoder, batch 1
    gen.pt2         generation, frame_batch frames
    params.pt       both networks' parameters and buffers under flat
                    ``g/<name>`` and ``m/<name>`` keys, in their dtype

The weights are arguments of every stage, not constants inside it, so no
``.pt2`` holds a copy of them and ``ServingPipeline.load_weights`` swaps
weights of the same shapes without exporting again. A program runs on
the device it was traced on ("cpu" or "cuda").

A two-device artifact (``platforms=("cpu", "cuda")``, the JAX package's
``--platforms cpu,tpu``) holds the four programs once per device, in
``cpu/`` and ``cuda/``, beside one ``manifest.json`` and one
``params.pt``; ``load_serving_pipeline`` loads the programs of the
device it is given and moves the weights there. As the JAX package's
multi-platform stages trace its portable dense attention, the CPU
programs trace the plain attention (``fused_attention.
plain_cpu_attention``) and hold no ``samt`` op; the card's programs keep
kernel K1. Unlike XLA, which lowers a TPU program on any host,
``torch.export`` traces a CUDA program only with a card: exporting for
``cuda`` without one raises before anything is written, so no artifact
names a device whose programs it lacks. A single-device artifact keeps
the programs at the top of the directory, as before.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from .inference import ReenactmentPipeline
from .ops import fused_attention  # registers the samt ops
from .utils.misc import strict_float32

FORMAT_VERSION = 1
_STAGES = ("kp1", "kpN", "enc", "gen")
PARAMS_FILE = "params.pt"


def _str_keys(feats):
    """The encoder's skip features are keyed by integer resolution; the
    enc -> gen boundary carries string keys, as the JAX package's does."""
    return {"latent": feats["latent"],
            "feats": {str(k): v for k, v in feats["feats"].items()}}


def _int_keys(feats):
    return {"latent": feats["latent"],
            "feats": {int(k): v for k, v in feats["feats"].items()}}


class _Stage(nn.Module):
    """A stage function as the forward of a module that holds no
    parameters, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _pipeline_on(pipeline: ReenactmentPipeline, device: str
                 ) -> ReenactmentPipeline:
    """A copy of ``pipeline`` (its networks and options) on ``device``."""
    p = pipeline
    return ReenactmentPipeline(
        copy.deepcopy(p.net_g).to(device),
        copy.deepcopy(p.motion_estimator).to(device), relative=p.relative,
        adapt_scale=p.adapt_scale, frame_batch=p.frame_batch, w=p.w,
        compute_dtype=p.compute_dtype, u8_io=p.u8_io,
        host_kp_downsample=p.host_kp_downsample, yuv420_io=p.yuv420_io,
        device=device)


def _export_programs(p: ReenactmentPipeline, out_dir: str) -> None:
    """The four stage programs of pipeline ``p``, traced on its device,
    saved to ``out_dir``."""
    dev = p.device
    fb, img = int(p.frame_batch), int(p.img_size)
    in_dtype = torch.uint8 if p.u8_io else torch.float32
    pre_ds = bool(p.host_kp_downsample)
    if pre_ds:
        kp_hw, kp_dtype = int(round(img * p.kp_scale)), torch.bfloat16
    else:
        kp_hw, kp_dtype = img, in_dtype
    g, m = p.g_weights, p.m_weights

    def kp_fn(m_weights, images):
        return p._kp_impl(m_weights, images, pre_ds)

    def enc_fn(g_weights, source):
        return _str_keys(p._enc_impl(g_weights, source))

    def gen_fn(g_weights, m_weights, source, src_feats, kp_s, kp_d, kp_i):
        return p._gen_impl(g_weights, m_weights, source, _int_keys(src_feats),
                           kp_s, kp_d, kp_i)

    kp1_in = torch.zeros((1, kp_hw, kp_hw, 3), dtype=kp_dtype, device=dev)
    kpN_in = torch.zeros((fb, kp_hw, kp_hw, 3), dtype=kp_dtype, device=dev)
    src_in = torch.zeros((1, img, img, 3), dtype=in_dtype, device=dev)

    def export(fn, *args):
        return torch.export.export(_Stage(fn), args, strict=False)

    with torch.no_grad():
        # the stages' outputs at these shapes are the later stages' inputs
        # (kp_source and kp_initial as distinct tensors: export would
        # trace one tensor passed twice as one input)
        kp_s, kp_i = kp_fn(m, kp1_in), kp_fn(m, kp1_in)
        kpN = kp_fn(m, kpN_in)
        feats = enc_fn(g, src_in)
        programs = {
            "kp1": export(kp_fn, m, kp1_in),
            "kpN": export(kp_fn, m, kpN_in),
            "enc": export(enc_fn, g, src_in),
            "gen": export(gen_fn, g, m, src_in, feats, kp_s, kpN, kp_i),
        }
    os.makedirs(out_dir, exist_ok=True)
    for name, ep in programs.items():
        # the example inputs hold the weights: params.pt keeps their one copy
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(out_dir, f"{name}.pt2"))


def export_pipeline(pipeline: ReenactmentPipeline, out_dir: str,
                    platforms: Optional[Sequence[str]] = None) -> None:
    """Export ``pipeline``'s stages and weights to ``out_dir``, for each
    device of ``platforms`` ("cpu", "cuda"; by default the pipeline's
    own device alone).

    Its options (relative motion, scale adaptation, ``w``, the frame
    batch, the frame types) are baked into the programs as its live
    stages run them; the manifest records them for the host side. Each
    stage is traced at its static shapes: ``kp1`` at batch 1 and ``kpN``
    at ``frame_batch`` (both at the keypoint resolution in bfloat16 with
    ``host_kp_downsample``), ``enc`` at batch 1, and ``gen`` on ``kp1``'s
    keypoints for the source and ``kpN``'s for the driving frames. For a
    device other than the pipeline's, a copy of the pipeline on it is
    traced; with two devices the CPU's programs trace the plain attention
    (see the module docstring). Raises, before writing anything, for an
    unknown device or for "cuda" where no card is visible."""
    p = pipeline
    platforms = list(platforms or [p.device.type])
    for dev in platforms:
        if dev not in ("cpu", "cuda") or platforms.count(dev) > 1:
            raise ValueError(f"platforms {platforms}: want cpu and/or cuda, "
                             f"each once")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError(
            f"platforms {platforms}: exporting the cuda programs needs a "
            f"CUDA device, and there is none here (torch.export traces a "
            f"card's program only on a card)")
    two = len(platforms) > 1
    for dev in platforms:
        on_dev = p if p.device.type == dev else _pipeline_on(p, dev)
        with (fused_attention.plain_cpu_attention() if two and dev == "cpu"
              else contextlib.nullcontext()):
            _export_programs(on_dev, os.path.join(out_dir, dev) if two
                             else out_dir)

    g, m = p.g_weights, p.m_weights
    in_dtype = torch.uint8 if p.u8_io else torch.float32
    flat = {**{f"g/{k}": v for k, v in g.items()},
            **{f"m/{k}": v for k, v in m.items()}}
    torch.save({k: v.detach().cpu() for k, v in flat.items()},
               os.path.join(out_dir, PARAMS_FILE))
    manifest = {
        "format_version": FORMAT_VERSION,
        "img_size": int(p.img_size),
        "frame_batch": int(p.frame_batch),
        "relative": bool(p.relative),
        "adapt_scale": bool(p.adapt_scale),
        "w": float(p.w),
        "compute_dtype": _dtype_name(p.compute_dtype),
        "u8_io": bool(p.u8_io),
        "yuv420_io": bool(p.yuv420_io),
        "host_kp_downsample": bool(p.host_kp_downsample),
        "kp_scale": float(p.kp_scale),
        "input_dtype": _dtype_name(in_dtype),
        "platforms": platforms,
        "param_dtypes": {k: _dtype_name(v.dtype) for k, v in flat.items()},
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


class ServingPipeline:
    """Runs reenactment from an exported artifact directory.

    The host side (frame batches, padding, the anchor split, the host
    keypoint downsample) is the live pipeline's own; every stage is a
    loaded program, called with the weights as arguments."""

    def __init__(self, manifest: Dict[str, Any],
                 programs: Dict[str, Any], g_weights, m_weights,
                 device: Optional[str] = None):
        self.manifest = manifest
        self.frame_batch = int(manifest["frame_batch"])
        self.relative = bool(manifest["relative"])
        self.adapt_scale = bool(manifest["adapt_scale"])
        self.w = float(manifest["w"])
        self.u8_io = bool(manifest["u8_io"])
        self.yuv420_io = bool(manifest["yuv420_io"])
        self.host_kp_downsample = bool(manifest["host_kp_downsample"])
        self.kp_scale = float(manifest["kp_scale"])
        self.img_size = int(manifest["img_size"])
        self.compute_dtype = getattr(torch, manifest["compute_dtype"])
        self.device = torch.device(device or manifest["platforms"][0])
        if self.compute_dtype == torch.float32:
            strict_float32(self.device)
        self._stages = {k: ep.module() for k, ep in programs.items()}
        self.load_weights(g_weights, m_weights)

    def _take(self, net: str, weights) -> Dict[str, torch.Tensor]:
        """``weights`` of network ``net`` ("g" or "m") on the device, in
        the artifact's dtypes and order; raises on a missing, extra or
        reshaped entry."""
        dtypes = {k[2:]: getattr(torch, v)
                  for k, v in self.manifest["param_dtypes"].items()
                  if k.startswith(net + "/")}
        if set(weights) != set(dtypes):
            raise ValueError(
                f"{net} weights differ from the artifact's: missing "
                f"{sorted(set(dtypes) - set(weights))[:5]}, extra "
                f"{sorted(set(weights) - set(dtypes))[:5]}")
        out = {k: weights[k].detach().to(self.device, dt)
               for k, dt in dtypes.items()}
        old = getattr(self, f"{net}_weights", None)
        for k, v in (old or {}).items():
            if out[k].shape != v.shape:
                raise ValueError(f"{net}/{k}: shape {tuple(out[k].shape)} "
                                 f"!= the artifact's {tuple(v.shape)}")
        return out

    def load_weights(self, g_weights, m_weights) -> None:
        """Swap in weights of the same names and shapes (parameters and
        buffers by name, e.g. ``inference.net_weights(net)``) without
        touching the programs."""
        self.g_weights = self._take("g", g_weights)
        self.m_weights = self._take("m", m_weights)

    # stage adapters of ReenactmentPipeline's surface
    def _kp_fn(self, images, pre_downsampled: bool = False):
        x = self._to_device(images)
        if x.shape[0] not in (1, self.frame_batch):
            raise ValueError(
                f"serving kp stage exported for batch 1 or "
                f"{self.frame_batch}, got {x.shape[0]}")
        stage = "kp1" if x.shape[0] == 1 else "kpN"
        return self._stages[stage](self.m_weights, x)

    def _enc_fn(self, source):
        return self._stages["enc"](self.g_weights, self._to_device(source))

    def _gen_fn(self, source, src_feats, kp_source, kp_driving, kp_initial):
        return self._stages["gen"](self.g_weights, self.m_weights,
                                   self._to_device(source), src_feats,
                                   kp_source, kp_driving, kp_initial)

    @torch.no_grad()
    def estimate_kp(self, images) -> Dict[str, torch.Tensor]:
        """Keypoints of batch-1 or frame_batch frames, through the host
        downsample when that is the only keypoint stage exported."""
        if self.host_kp_downsample:
            return self._kp_fn(self._host_kp_prep(images), True)
        return self._kp_fn(images)

    # the host side is shared with the live pipeline
    _to_device = ReenactmentPipeline._to_device
    _host_kp_prep = ReenactmentPipeline._host_kp_prep
    _kp_frames = ReenactmentPipeline._kp_frames
    animate = ReenactmentPipeline.animate
    animate_with_anchor = ReenactmentPipeline.animate_with_anchor


def load_serving_pipeline(art_dir: str, device=None) -> ServingPipeline:
    """The pipeline of the artifact in ``art_dir`` on ``device``, one of
    the manifest's platforms: by default the card when the artifact has
    programs for it, else its one device. Raises on another format
    version, on a device the artifact has no programs for, and for the
    card where there is none (it does not fall back to the CPU's
    programs)."""
    with open(os.path.join(art_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest.get('format_version')} != "
            f"supported {FORMAT_VERSION}")
    platforms = manifest["platforms"]
    if device is not None:
        dev = torch.device(device).type
    else:
        dev = "cuda" if "cuda" in platforms else platforms[0]
    if dev not in platforms:
        raise ValueError(f"the artifact in {art_dir} was exported for "
                         f"{', '.join(platforms)}, not {dev}")
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact in {art_dir} is loaded for cuda, "
                           f"and there is no CUDA device here")
    stage_dir = art_dir if len(platforms) == 1 else os.path.join(art_dir,
                                                                 dev)
    programs = {name: torch.export.load(os.path.join(stage_dir,
                                                     f"{name}.pt2"))
                for name in _STAGES}
    flat = torch.load(os.path.join(art_dir, PARAMS_FILE), map_location=dev,
                      weights_only=True)
    g = {k[2:]: v for k, v in flat.items() if k.startswith("g/")}
    m = {k[2:]: v for k, v in flat.items() if k.startswith("m/")}
    return ServingPipeline(manifest, programs, g, m, device=dev)
