#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port: builds its CUDA kernels
(reporting each kernel's registers, shared memory, spills and tensor-core
instructions), holds each against its plain PyTorch version (K1 and K3 at
the main paths' shapes, K1 also on the inputs the flagship pipeline gives
it; K2 and K4, which no path calls, at those shapes relaid to their
layouts; K1, K3 and K4 also at ragged shapes; K3 and K4 on the kernel
their plan picks, wgmma at every path shape, with the mma.sync kernel
checked and timed beside it there), checks the tiny config on
the card against the port on the CPU, and drives the port's three paths
at the flagship 256x256 width with seeded random weights:
- the reenactment path (ReenactmentPipeline.animate), uint8 frames in and
  out as bench.py runs it, then a profile of one frame batch of it;
- the training step (training.Trainer.train_step) of options/train.yml,
  batch 2, bf16 compute, then a profile of one step of it;
- the ablations: each switch of the generator, the keypoint detector and
  the dense-motion network that the paper ablates (ABLATIONS), set alone
  or, for the warped-source query and MRFA, together: the tiny config's
  frames and one tiny train step on the card against the CPU, one
  flagship frame batch and one flagship train step with D on (K1 and K3
  launched as the config says), K1 against its plain version on the
  captured inputs of the variants whose attention reads other codebook
  rows or no position embedding;
- the training entry point (train.run) at the same config over a native
  frame cache of seeded image-like frames: 4 steps with checkpoints at
  steps 2 and 4, the step-2 checkpoint restored bit for bit, and a second
  run that resumes from it;
- distributed: train.run through --launcher pytorch as a world of one
  over NCCL (the gradient all-reduce runs; the weights after 2 steps
  against --launcher none), two spawned ranks (NCCL on two cards, or gloo
  with both ranks on cuda:0 when there is one card): the tiny f32 step on
  a split batch against one process on the whole batch, and 2 flagship
  bf16 steps whose ranks stay bit-identical (K1 and K3 per rank per
  step, ms/step, the all-reduce's time); remat false / true / selective
  at options/train_v5e2.yml's batch 8 (peak memory, ms/step, K3's
  forward launches, gradients across the modes); the main path's pipeline
  split over a mesh of the visible cards ([cuda:0, cuda:0] on one card)
  against mesh=None;
- the inference and evaluation entry points, at the flagship config:
  trained weights written by training.export_params and loaded by
  demo.build_and_load (frames bit-identical to the in-memory pipeline's),
  find_best_frame_kp and animate_with_anchor over 48 frames (K1 32 times
  per frame batch), --fast's rgb_to_yuv420 and host keypoint downsample
  against the CPU and the card's own downsample, test.run over seeded
  pairs (equal to direct calls of the networks; the tiny config's within
  1 level of the CPU), and the FID, LPIPS and AED networks at their real
  input sizes against the CPU, timed. The card's machine has no image
  decoder (OpenCV, imageio): reading and writing image and video files,
  the I420 fetch of --fast and its uint8 host downsample (OpenCV) are
  held by the CPU tests only;
- serving: the main path's pipeline exported with serving.export_pipeline
  (torch.export programs, weights as arguments), loaded back and run on
  the main path's frames (within 1 level of the live frames, K1 launched
  from the exported generation program), and a weight swap without
  export at the tiny config.
- VQGAN stage-1 training (sr_model): model_api.SRModel over a
  VQAutoEncoder at the flagship generator's widths
  (configs.FLAGSHIP_VQGAN_SR, batch 2, f32), 5 steps of the L1 pixel
  loss on an identity target (ms/step, peak memory, l_pix falling, no
  samt kernel launched: the JAX VQAutoEncoder reaches no Pallas kernel),
  test() and PSNR validation; full-width forwards of VQAutoEncoder (equal
  codebook indices) and AutoEncoder_MSDecoder, PerceptualLoss with a
  style term, VGGFeatureExtractor, and r1_penalty and
  gradient_penalty_loss over the flagship discriminator with their double
  backward, each against the CPU; one tiny SRModel step against the CPU;
  and train.vgg_weights read by the flagship Trainer.
- attention_widths (after the ablations): K1 and K2 at every attention
  shape of a flagship frame batch at n_head 1, 2 and 32 (head widths 1 to
  256: the d = 128 wgmma kernel at bf16 d = 128, the d = 256 wgmma kernel
  at bf16 d = 256, the float32 wide kernel at float32 d = 128 and 256,
  the d = 1 kernel at d = 1) and at ragged d = 72 to 1032
  (RAGGED_WIDTHS: every instantiation of the wgmma designs and of the
  float32 wide kernel; the d-chunked kernels at bf16 161 and above 512
  and at float32 1032, timed there), against their plain versions in
  both dtypes, timed against the bound and SDPA (float32 too above
  d = 64); at TIMED_WIDTHS (one appearance launch of a frame batch at
  bf16 d = 96, 192 and 384, float32 d = 320 and 640) the kernel plan
  picks against the d-chunked kernel forced through plan, in turns, and
  SDPA, K2 from a transposed view; one flagship frame batch at each
  n_head with its 32 K1 launches counted by the kernel plan names (at
  n_head 1 the appearance transformer's 16 on the d = 256 wgmma kernel,
  at n_head 2 on the d = 128 one), one at appearance d = 96 (its 16 on
  the d = 128 design at D = 96), one at appearance d = 384 (its 16 on the
  d = 512 design, its 32 captured inputs held against the plain
  version), and one in float32 at n_head 1 (its 16 on the float32 wide
  kernel); the tiny config with motion d = 1 and appearance d = 128, and
  at appearance d = 320 and 640, on the card against the CPU (d = 1 and
  wide kernels);
- train_options (after the train profile): the flagship Trainer with a
  fixed GAN weight (use_adaptive_weight false) and weight decay on its
  three optimizers, 3 timed steps (K1 and K3 as the train path, no
  adaptive-weight probe), the tiny step card vs CPU with both options,
  and steps with the generator's telemetry on and off in turns;
- model_api_mesh (after distributed): AppMotionCompModel fed the global
  batch on two gloo ranks on cuda:0, bit for bit the trainer's step on
  each rank's slice, test() the global batch on both ranks;
- serving also exports a two-device (cpu, cuda) artifact: the card's
  programs against the live card pipeline (K1 from gen), the CPU's
  (plain attention, no samt op) at the tiny config against the live CPU
  pipeline;
- blocks: DCNv2Pack, ModulatedDeformConvPack, upfirdn2d,
  fused_leaky_relu, SPADEResnetBlock, KPHourglass and flow_warp at real
  widths, each on the card against the CPU, with ms and peak memory.
- data_utils (last): every module of the data/ and utils/ slice imported
  on this machine (printing which of OpenCV, PIL, imageio, PyYAML and
  lmdb it lacks); one flagship frame batch profiled with
  utils.profiler.trace and annotate (the Chrome trace holds K1's 32
  launches inside the annotated range, as the launch counter does) and
  timed by StepTimer; duf_downsample and grad_layer on the card against
  the CPU; TiledRestorer over grad_layer at 512x512, its tiles against
  the whole pass bit for bit.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card; exits non-zero without one. Prints the card's name
and power limit, one JSON line of kernel results, and as its last line
{"ok": true, "device": {...}}. Details, the profile's every kernel
included, go to chiprun_out/chip_smoke.json. Any failed check raises.
"""
import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter, defaultdict
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the rate of
# each input type's arithmetic (f32 on the CUDA cores, bf16 on the tensor
# cores), used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Hopper's special-function units: exp2 results per SM per clock (16 per
# SM, 4 per SM sub-partition), the floor of softmax attention at d <= 64
EXP_PER_SM_CLOCK = 16

FRAMES = 64        # driving frames of the main path: 4 frame batches
FRAME_BATCH = 16   # bench.py's frame batch; also the B of every K1 shape

TRAIN_STEPS = 5    # timed steps of the training path, after one warm-up
TRAIN_BATCH = 2    # options/train.yml's batch per card

ANCHOR_FRAMES = 48  # driving frames of the anchor path: 3 frame batches
ANCHOR_AT = 20      # the driving frame that is the source (the anchor)
EVAL_PAIRS = 2      # pairs of test.run at the flagship config

CLI_STEPS = 4                  # steps of the training entry point's run
CACHE_VIDEOS, CACHE_FRAMES = 8, 8  # its native frame cache: 12.6 MB
CACHE_SIZE = 256                   # frames of the flagship's img_size

# (kernel, key of its kernels-line entry, earlier time in ms) on an NVIDIA
# H100 80GB HBM3 at 700.00 W, by the profiler's device time, as measured
# when each was last redesigned: K1 per frame batch with its 32 launches
# all in bf16 (device_ms_bf16) and its motion transformer's 16 launches in
# float32 as the pipeline gives them (device_ms_motion), the appearance
# transformer's 16 bf16 launches at n_head 2 (d = 128, the d = 128 wgmma
# kernel) and at n_head 1 (d = 256, the d = 256 wgmma kernel), the
# appearance transformer's 16 float32 launches at n_head 1 (d = 256, the
# float32 wide kernel), the motion transformer's 16 launches at n_head 32
# in bf16 (d = 1, the d = 1 kernel), one call at each TIMED_WIDTHS shape
# (bf16 d = 96 and 192 on the wgmma designs at D = 96 and 192, float32
# d = 320 on the float32 wide kernel at C = 384, bf16 d = 384 on the
# d = 512 wgmma design at W = 192, float32 d = 640 on the wide kernel at
# C = 640), K3 per train step and K4
# over K3's forward shapes, both bf16 on the wgmma kernel (their calls are
# short enough that per-call event times measure the host). On a card at
# that power limit none may be more than 10% slower now.
PREVIOUS_MS = [("fused_attention_packed", "device_ms_bf16", 2.41),
               ("fused_attention_packed", "device_ms_motion", 1.17),
               ("fused_attention_packed", "device_ms_appearance_n_head_2",
                0.575),
               ("fused_attention_packed (wgmma d = 256)", "device_ms", 0.762),
               ("fused_attention_packed (f32 wide)", "device_ms", 6.40),
               ("fused_attention_packed (d = 1)", "device_ms_bf16", 2.83),
               ("fused_attention_packed (wgmma d = 96)", "device_ms", 0.0382),
               ("fused_attention_packed (wgmma d = 192)", "device_ms",
                0.0873),
               ("fused_attention_packed (f32 wide d = 320)", "device_ms",
                0.827),
               ("fused_attention_packed (wgmma d = 384)", "device_ms", 0.107),
               ("fused_attention_packed (f32 wide d = 640)", "device_ms",
                0.802),
               ("conv3x3", "device_ms", 2.97),
               ("conv3x3_nhwc", "device_ms", 1.16)]

# profiled kernel-name substrings -> kind, first match wins
KINDS = [
    ("attention K1", ("attn_packed_kernel",)),
    ("conv3x3 K3", ("conv3x3_kernel",)),
    ("warp (grid_sample)", ("grid_sampler",)),
    ("norm", ("norm", "welford", "rowwisemoments", "computefusedparams")),
    ("resize", ("upsample", "interpolate", "bilinear", "nearest")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "fprop", "nchw",
                     "nhwc", "winograd")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "matmul", "ampere_",
                "sm90_")),
    ("softmax/reduce", ("softmax", "reduce")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("copy/cast/elementwise", ("elementwise", "copy", "cat", "index",
                               "fill")),
]


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True).stdout.strip()


class PhaseClock(dict):
    """The script's report: setting a key also records, in ``seconds``,
    the wall time since the key set before it (for the first, since the
    report was made), which is the time of the phase that computed its
    value."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seconds = {}
        self._last = time.perf_counter()

    def __setitem__(self, key, value):
        now = time.perf_counter()
        self.seconds[key] = now - self._last
        self._last = now
        super().__setitem__(key, value)


def time_ms(torch, fn, iters, warmup=2):
    """Median of per-call CUDA-event times, after warmup calls. Each call's
    time includes the host's work between the start event and the first
    launch, so a call whose kernels are shorter than that measures the
    host (device_ms measures the kernels alone)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def activity_lost(device_ms, pending_ms):
    """Whether a profiler session lost device activity: the card still had
    ``pending_ms`` of queued work when the host had launched all of it
    (the device was busy for about that long), and the session recorded
    under half of that (less 0.05 ms for the first launch's latency and
    the gaps between kernels). Late in a long process the card machine's
    profiler has recorded a fifth of a call's device time, then none."""
    return device_ms < 0.5 * pending_ms - 0.05


# the start of device_times' error when every session lost device activity
PROFILER_LOST = "the profiler lost device activity"


def device_times(torch, fn, iters=10, attempts=3):
    """Device time of one call of ``fn`` by kernel name: every kernel and
    memset it launches, summed by torch.profiler over ``iters`` calls after
    one warm-up call, per call; no host time, unlike time_ms. Now and then
    a profiler session on the card's machine records no device activity,
    or only part of it (activity_lost, against CUDA events around the
    session); such a session is run again, up to ``attempts`` sessions."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            end.record()
            end.synchronize()
        times = {evt.key: evt.self_device_time_total / 1e3 / iters
                 for evt in prof.key_averages()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and evt.self_device_time_total > 0}
        pending_ms = start.elapsed_time(end) - host_ms
        if times and not activity_lost(iters * sum(times.values()),
                                       pending_ms):
            return times
    raise AssertionError(
        f"{PROFILER_LOST} in {attempts} sessions: the "
        f"last recorded {iters * sum(times.values()):.4f} ms of device time "
        f"where {pending_ms:.4f} ms of queued work was left when the host "
        f"had launched it")


def device_ms(torch, fn, iters=10, attempts=3):
    """Device time of one call of ``fn``: device_times summed."""
    return sum(device_times(torch, fn, iters, attempts).values())


# ---------------------------------------------------------------------------
# kernel K1: every attention shape of one flagship frame batch
# ---------------------------------------------------------------------------

def exp_rate(torch):
    """Exponentials per second at the card's top SM clock: the special-
    function units give EXP_PER_SM_CLOCK results per SM per clock; the SM
    count from the device, the clock from nvidia-smi."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "--id=0"], check=True, capture_output=True,
        text=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "sm_clock_max_mhz": mhz,
            "exp_per_s": EXP_PER_SM_CLOCK * sms * mhz * 1e6}


def attention_cases(B, L=1024, H=8, E_app=256):
    """(name, B, L, E, H, K, shared context, bias, launches per frame
    batch) for the 32 attention launches of one frame batch at the
    flagship config (n_head H: 8 as shipped; the appearance transformer's
    width E_app: 256 as shipped): 4 motion and 4 appearance passes, each 2
    layers of self-attention over the L tokens and cross-attention
    against the first 256*idx codebook entries; only the first appearance
    layer carries a key bias."""
    cases = [("motion_self", 32, H, L, False, False, 8)]
    cases += [(f"motion_cross_K{256 * i}", 32, H, 256 * i, True, False, 2)
              for i in range(1, 5)]
    cases += [("app_self_bias", E_app, H, L, False, True, 4),
              ("app_self", E_app, H, L, False, False, 4)]
    cases += [(f"app_cross_K{256 * i}", E_app, H, 256 * i, True, False, 2)
              for i in range(1, 5)]
    return [(n, B, L, E, H, K, sh, bi, per) for n, E, H, K, sh, bi, per
            in cases]


# (name, B, L, E, H, K, shared context, bias, 0) on no path, checked and
# not timed (but for the train step's), each with a bias that masks every
# key of batch row 0: L and K off the query and key tiles at d = 4 and 32,
# the train step's B = 2 (timed; the wgmma kernel's 64-row query tiles, and
# at n_head 2, d = 128, the d = 128 wgmma kernel's 128-row items: 32 of
# them for the card's SMs), the tiny config's d = 2 and 8, and the wgmma
# kernel's other widths, d = 16 and 64
RAGGED_ATTENTION = [
    ("ragged_L1000_K1000_d4", FRAME_BATCH, 1000, 32, 8, 1000, False, True,
     0),
    ("ragged_L1000_K1000_d32", FRAME_BATCH, 1000, 256, 8, 1000, False, True,
     0),
    ("train_B2_self_d4", TRAIN_BATCH, 1024, 32, 8, 1024, False, True, 0),
    ("train_B2_cross_K768_d32", TRAIN_BATCH, 1024, 256, 8, 768, True, True,
     0),
    ("train_B2_cross_K768_d128", TRAIN_BATCH, 1024, 256, 2, 768, True, True,
     0),
    ("tiny_self_d2", 4, 64, 8, 4, 64, False, True, 0),
    ("tiny_cross_K48_d8", 4, 64, 32, 4, 48, True, True, 0),
    ("ragged_L700_K300_d16", 3, 700, 128, 8, 300, False, True, 0),
    ("ragged_L1000_K200_d64", 2, 1000, 512, 8, 200, True, True, 0),
]


def random_bias(torch, gen, B, K):
    """A (B, K) float32 bias masking 30% of the keys and every key of batch
    row 0, whose output must then be 0."""
    drop = torch.rand(B, K, generator=gen, device="cuda") < 0.3
    drop[0] = True
    return torch.where(drop, -1e30, 0.0).to(torch.float32)


def assert_attention_close(torch, out, ref, all_masked_row0):
    if out.dtype == torch.float32:
        # __expf and the online softmax's running max differ from the
        # plain version's exact exp and global max by a few float32 ulps
        # per term
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        # both sides compute in float32 (the kernel keeps each softmax
        # weight to 16 bits as bf16 hi + lo) and round once to bf16: a
        # result straddling a rounding boundary differs by one bf16 ulp,
        # at most 2^-7 of its magnitude
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-3,
                                   rtol=2 ** -7)
    assert torch.isfinite(out).all()
    if all_masked_row0:
        assert out[0].abs().max().item() == 0.0, "all-masked row"


def attention_times(torch, kernel, plain, library):
    """CUDA-event times of the kernel, the plain version and the library
    call, and the profiler's device times of the kernel and the library
    call (at ~0.05 ms a call, the event times measure the host)."""
    with torch.no_grad():
        return {"ms": time_ms(torch, kernel, iters=20),
                "plain_ms": time_ms(torch, plain, iters=5),
                "library_ms": time_ms(torch, library, iters=20),
                "device_ms": device_ms(torch, kernel),
                "library_device_ms": device_ms(torch, library)}


def attention_bound(q, k, v, bias, scores, d, rate):
    """The least time of one call, the largest of: the bytes (q, k, v and
    the bias read once, the output written once) over the HBM rate; 2
    FLOP per multiply-add of q.k and of p.v (4d per score, the function's
    work) over the bf16 tensor-core peak (the f32 CUDA-core peak for
    float32 inputs); one exponential per score over the special-function
    units' rate. bound_by is "bytes" or "operations"; bound_kind names
    which of the three binds (the products at the wide heads). For
    bfloat16, hilo_products_ms is the tensor cores' time for the bf16
    kernels' own products, 6d per score (p.v taken twice, as bf16 hi +
    lo): an estimate beside the bound, not part of it."""
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + (
        bias.numel() * 4 if bias is not None else 0)
    dtype = str(q.dtype).split(".")[1]
    flop = "tensor-core FLOP" if dtype == "bfloat16" else "CUDA-core FLOP"
    parts = {"bytes": nbytes / HBM_BYTES_PER_S,
             flop: 4 * d * scores / PEAK_FLOPS[dtype],
             "exponentials": scores / rate["exp_per_s"]}
    kind = max(parts, key=parts.get)
    out = {"bound_ms": 1e3 * parts[kind],
           "bound_by": "bytes" if kind == "bytes" else "operations",
           "bound_kind": kind,
           "bound_parts_ms": {k: 1e3 * t for k, t in parts.items()}}
    if dtype == "bfloat16":
        out["hilo_products_ms"] = 1e3 * 6 * d * scores / PEAK_FLOPS[dtype]
    return out


def f32_issue_slots(d, rows):
    """Issue slots that one score of the float32 kernel takes
    (attn_packed_kernel<DMAX, R>, DMAX = d rounded up to a power of two,
    R = rows per thread): per score and row 2 DMAX FMAs (q.k and p.v), the
    max, the exponent's subtraction, the exponential's issue and the row
    sum; per key 2 ceil(DMAX / 4) 16-byte shared loads of k and v and 1 of
    the bias, shared by the R rows; per 16 keys and row the rescale (max,
    subtraction, exponential, and the multiplies of the sum and the DMAX
    accumulators)."""
    dmax = 1 << (d - 1).bit_length()
    return (2 * dmax + 4 + (2 * -(-dmax // 4) + 1) / rows
            + (4 + dmax) / 16)


def attention_issue_ms(scores, d, rows, rate):
    """The float32 kernel's issue-slot estimate in ms: its issue slots
    over the 4 schedulers x 32 lanes of each SM at the top clock. Not a
    bound of the function (the bound counts 4d FLOP and one exponential a
    score): what the f32 half's instruction stream needs at the least."""
    per_s = 128 * rate["sms"] * rate["sm_clock_max_mhz"] * 1e6
    return 1e3 * scores * f32_issue_slots(d, rows) / per_s


def attention_halves(rows):
    """On-path device sums of K1's two halves per frame batch of
    FRAME_BATCH (the appearance transformer's bf16 d = 32 launches, the
    motion transformer's float32 d = 4 ones), SDPA's beside each, the
    bound and its share (and the f32 half's issue-slot estimate); and the
    train step's timed B = 2 shapes."""
    halves = {}
    for half, dtype in (("appearance", "bfloat16"), ("motion", "float32")):
        timed = [r for r in rows if r["on_path"] and r["dtype"] == dtype]
        h = {key: sum(r[key] * r["launches_per_frame_batch"] for r in timed)
             for key in ("device_ms", "library_device_ms", "bound_ms")
             + (("issue_slot_ms",) if dtype == "float32" else ())}
        h["launches_per_frame_batch"] = sum(r["launches_per_frame_batch"]
                                            for r in timed)
        h["bound_share"] = h["bound_ms"] / h["device_ms"]
        halves[half] = h
        print(f"K1 {half} half on the path ({dtype}, "
              f"{h['launches_per_frame_batch']} "
              f"launches a frame batch): {h['device_ms']:.4f} ms device, "
              f"SDPA {h['library_device_ms']:.4f}, bound "
              f"{h['bound_ms']:.4f} (share {h['bound_share']:.3f})"
              + (f", issue-slot estimate {h['issue_slot_ms']:.4f}"
                 if "issue_slot_ms" in h else ""), flush=True)
    halves["train_B2"] = {r["case"] + "_" + r["dtype"]: r["device_ms"]
                          for r in rows if r["case"].startswith("train_B2")}
    return halves


def attention_note(row):
    if "ms" not in row:  # checked, not timed
        return ""
    return (f"  kernel {row['device_ms']:.4f} ms device ({row['ms']:.4f} "
            f"events)  sdpa {row['library_device_ms']:.4f} device "
            f"({row['library_ms']:.4f} events)  plain {row['plain_ms']:.4f}"
            f"  bound {row['bound_ms']:.4f} ({row['bound_kind']}), share "
            f"{row['bound_share']:.3f}"
            + (f"  hi+lo products {row['hilo_products_ms']:.4f}"
               if "hilo_products_ms" in row else ""))


def launched_kernel(fa, before):
    """The one kernel name that fa.launch_kernels gained since ``before``
    (a copy of it)."""
    gained = list((fa.launch_kernels - before).elements())
    assert len(gained) == 1, gained
    return gained[0]


def check_attention(torch, fa, B, rate, L=1024, cases=None):
    """Hold the kernel against the plain version at every main-path shape
    and at RAGGED_ATTENTION (or at ``cases``) in float32 and bfloat16; at
    the main-path shapes time kernel, plain version and
    F.scaled_dot_product_attention at bfloat16 and, for the motion
    transformer's calls, also at float32, the dtype the bf16 pipeline
    gives them (the JAX graph's type promotion of the float32 flow
    residual runs the motion pass in float32); time the train step's B = 2
    shapes of RAGGED_ATTENTION in both dtypes. Rows in the pipeline's dtype
    are marked on_path, and each row names the kernel that ran it. At the
    shipped widths bfloat16 at d = 16, 32 and 64 runs the wgmma kernel, at
    d = 2, 4 and 8 the mma.sync one, float32 the CUDA-core one
    (ops/fused_attention.py::plan)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    main_cases = cases is None
    if main_cases:
        cases = attention_cases(B, L) + RAGGED_ATTENTION
    for name, bb, ll, E, H, K, shared, with_bias, per_batch in cases:
        d = E // H
        path_dtype = "float32" if name.startswith("motion") else "bfloat16"
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)

            q = randn(bb, ll, E)
            kv_shape = (K, E) if shared else (bb, K, E)
            k, v = randn(*kv_shape), randn(*kv_shape)
            bias = random_bias(torch, gen, bb, K) if with_bias else None
            before = fa.launch_kernels.copy()
            with torch.no_grad():
                out = fa.fused_attention_packed(q, k, v, bias, num_heads=H)
                ref = fa.fused_attention_packed_reference(q, k, v, bias,
                                                          num_heads=H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert_attention_close(torch, out, ref, with_bias)
            row = {"case": name, "dtype": str(dtype).split(".")[1], "B": bb,
                   "L": ll, "K": K, "E": E, "H": H, "d": d,
                   "kernel": launched_kernel(fa, before),
                   "shared_kv": shared, "bias": with_bias,
                   "launches_per_frame_batch": per_batch, "calls": 1,
                   "on_path": bool(per_batch) and str(dtype).split(".")[1]
                   == path_dtype, "max_abs_err": err}
            # the main path's shapes, and the train step's B = 2 shapes:
            # bf16, the path's dtype, and float32 above d = 64; the
            # d-chunked kernels, on no frame batch, at the ragged shapes
            # they take
            timed = (per_batch or name.startswith("train_B2")
                     or row["kernel"] == "chunked")
            if timed and (dtype == torch.bfloat16 or row["on_path"]
                          or not per_batch or d > 64):
                # the library yardstick, timed only: SDPA on head-split
                # views
                qh = q.view(bb, ll, H, d).transpose(1, 2)
                kh = k.expand(bb, K, E).contiguous().view(
                    bb, K, H, d).transpose(1, 2)
                vh = v.expand(bb, K, E).contiguous().view(
                    bb, K, H, d).transpose(1, 2)
                mask = None if bias is None else \
                    bias.to(dtype)[:, None, None, :]
                row.update(attention_times(
                    torch,
                    lambda: fa.fused_attention_packed(q, k, v, bias,
                                                      num_heads=H),
                    lambda: fa.fused_attention_packed_reference(
                        q, k, v, bias, num_heads=H),
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask)))
                row.update(attention_bound(q, k, v, bias, bb * H * ll * K,
                                           d, rate))
                row["bound_share"] = row["bound_ms"] / row["device_ms"]
                if dtype == torch.float32:
                    row["issue_slot_ms"] = attention_issue_ms(
                        bb * H * ll * K, d,
                        fa.f32_rows(bb, H, ll, d, rate["sms"]), rate)
                del qh, kh, vh, mask
            rows.append(row)
            print(f"  K1 {name:23s} {row['dtype']:8s} d {d:3d} "
                  f"{row['kernel']:7s} max_abs_err {err:.3e}"
                  + attention_note(row),
                  flush=True)
            del q, k, v, bias, out, ref
    if main_cases:
        rows.append(check_bf16_bias(torch, fa, gen, B, L))
    return rows


def check_bf16_bias(torch, fa, gen, B, L):
    """K1 at the biased appearance shape (bf16, d = 32) with a bf16 bias:
    the wrapper casts it to float32, as the JAX package does, so the
    output is bit for bit the call's with that bias in float32, and within
    K1's tolerance of the plain version. A checked row, not timed."""
    name, bb, ll, E, H, K, shared, _, _ = attention_cases(B, L)[5]
    assert name == "app_self_bias"
    q, k, v = (torch.randn(bb, n, E, generator=gen, device="cuda").to(
        torch.bfloat16) for n in (ll, K, K))
    bias = random_bias(torch, gen, bb, K).to(torch.bfloat16)
    before = fa.launch_kernels.copy()
    with torch.no_grad():
        out = fa.fused_attention_packed(q, k, v, bias, num_heads=H)
        kernel = launched_kernel(fa, before)
        want = fa.fused_attention_packed(q, k, v, bias.float(), num_heads=H)
        ref = fa.fused_attention_packed_reference(q, k, v, bias.float(),
                                                  num_heads=H)
    torch.cuda.synchronize()
    assert torch.equal(out, want), "bf16 bias: not the float32 bias's output"
    assert_attention_close(torch, out, ref, True)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  K1 {name} with a bf16 bias: {kernel}, bit for bit the float32 "
          f"bias's output, max_abs_err {err:.3e}", flush=True)
    return {"case": name + "_bf16_bias", "dtype": "bfloat16", "B": bb,
            "L": ll, "K": K, "E": E, "H": H, "d": E // H, "kernel": kernel,
            "shared_kv": shared, "bias": True, "launches_per_frame_batch": 0,
            "calls": 1, "on_path": False, "max_abs_err": err}


def check_captured_attention(torch, fa, captured,
                             what="one flagship frame batch"):
    """Hold the kernel against the plain version on the (q, k, v, bias,
    num_heads) that the flagship pipeline passed to each attention call
    of one frame batch: real activations, not randn; K1's tolerances."""
    rows = []
    for i, (q, k, v, bias, H) in enumerate(captured):
        with torch.no_grad():
            out = fa.fused_attention_packed(q, k, v, bias, num_heads=H)
            ref = fa.fused_attention_packed_reference(q, k, v, bias,
                                                      num_heads=H)
        torch.cuda.synchronize()
        assert_attention_close(torch, out, ref, all_masked_row0=False)
        rows.append({"call": i, "dtype": str(q.dtype).split(".")[1],
                     "q": list(q.shape), "kv": list(k.shape), "H": H,
                     "bias": bias is not None,
                     "max_abs_err": (out.float() - ref.float()).abs()
                     .max().item(),
                     "max_abs_out": ref.float().abs().max().item()})
    worst = max(rows, key=lambda r: r["max_abs_err"])
    print(f"K1 on the {len(rows)} attention calls of {what} "
          f"(captured inputs): all within K1's bf16 tolerance; worst "
          f"max_abs_err {worst['max_abs_err']:.3e} at call {worst['call']} "
          f"(|out| up to {worst['max_abs_out']:.3f})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# kernel K2: K1's shapes in the head-split layout (no path calls it)
# ---------------------------------------------------------------------------

def check_attention_split(torch, fa, B, rate, L=1024, cases=None):
    """Hold K2 against its plain version at K1's main-path shapes relaid to
    (B, H, L, d), plus a ragged K on no path (or at ``cases``), in float32
    and bfloat16, with K1's tolerances; time kernel, plain version and
    F.scaled_dot_product_attention on the same head-split tensors at
    bfloat16 (and float32 at d = 1 and above 64). Each row names the
    kernel that ran it."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2345)
    main_cases = cases is None
    if main_cases:
        cases = attention_cases(B, L) + [("ragged_K1000_bias", B, L, 256, 8,
                                          1000, False, True, 0)]
    rows = []
    for name, bb, ll, E, H, K, shared, with_bias, per_batch in cases:
        d = E // H
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)

            q = randn(bb, H, ll, d)
            k = randn(1 if shared else bb, H, K, d)
            v = randn(1 if shared else bb, H, K, d)
            bias = random_bias(torch, gen, bb, K) if with_bias else None
            before = fa.launch_kernels.copy()
            with torch.no_grad():
                out = fa.fused_attention(q, k, v, bias)
                ref = fa.fused_attention_reference(q, k, v, bias)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert_attention_close(torch, out, ref, with_bias)
            row = {"case": name, "dtype": str(dtype).split(".")[1], "B": bb,
                   "H": H, "L": ll, "K": K, "d": d,
                   "kernel": launched_kernel(fa, before), "shared_kv": shared,
                   "bias": with_bias, "k1_launches_per_frame_batch":
                   per_batch, "max_abs_err": err}
            if per_batch and (dtype == torch.bfloat16 or d > 64 or d == 1):
                kk = k.expand(bb, H, K, d).contiguous()
                vv = v.expand(bb, H, K, d).contiguous()
                mask = None if bias is None else \
                    bias.to(dtype)[:, None, None, :]
                row.update(attention_times(
                    torch, lambda: fa.fused_attention(q, k, v, bias),
                    lambda: fa.fused_attention_reference(q, k, v, bias),
                    lambda: F.scaled_dot_product_attention(
                        q, kk, vv, attn_mask=mask)))
                row.update(attention_bound(q, k, v, bias, bb * H * ll * K,
                                           d, rate))
                row["bound_share"] = row["bound_ms"] / row["device_ms"]
                del kk, vv, mask
            rows.append(row)
            print(f"  K2 {name:17s} {row['dtype']:8s} d {d:3d} "
                  f"{row['kernel']:7s} max_abs_err {err:.3e}"
                  + attention_note(row),
                  flush=True)
            del q, k, v, bias, out, ref
    if main_cases:
        rows.append(check_transposed_split(torch, fa, gen, B, L))
    return rows


def check_transposed_split(torch, fa, gen, B, L):
    """K2 on the head-split view of token-major tensors, x.view(B, L, H,
    d).transpose(1, 2), at the biased appearance shape (bf16, d = 32): not
    contiguous, so the launch copies it; bit for bit the call on the
    contiguous copies, and within K1's tolerance of the plain version. A
    checked row, not timed."""
    name, bb, ll, E, H, K, shared, _, _ = attention_cases(B, L)[5]
    d = E // H
    q, k, v = (torch.randn(bb, n, E, generator=gen, device="cuda").to(
        torch.bfloat16).view(bb, n, H, d).transpose(1, 2)
        for n in (ll, K, K))
    assert not q.is_contiguous()
    bias = random_bias(torch, gen, bb, K)
    before = fa.launch_kernels.copy()
    with torch.no_grad():
        out = fa.fused_attention(q, k, v, bias)
        kernel = launched_kernel(fa, before)
        want = fa.fused_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), bias)
        ref = fa.fused_attention_reference(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(out, want), "transposed input: not the copy's output"
    assert_attention_close(torch, out, ref, True)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  K2 {name} from a transposed view: {kernel}, bit for bit the "
          f"contiguous call's output, max_abs_err {err:.3e}", flush=True)
    return {"case": name + "_transposed", "dtype": "bfloat16", "B": bb,
            "H": H, "L": ll, "K": K, "d": d, "kernel": kernel,
            "shared_kv": shared, "bias": True,
            "k1_launches_per_frame_batch": 0, "max_abs_err": err}


# ---------------------------------------------------------------------------
# kernel K3: every 3x3 conv shape of the training step's decoder region
# ---------------------------------------------------------------------------

def k3_forward_convs(net_cfg):
    """Counter of (C, Cout, H) over the 3x3 convs that one training forward
    runs in the decoder region, derived from the config alone: the blocks
    from the generator's first Upsample to its final RGB conv (exclusive)
    run on the main stream and on the parallel low-res stream; each
    connected scale inside the region adds, with multiscale_sft, a
    resblock on the concatenated 2C channels (C->C after it) and the two
    scale and the two shift convs, and with multiscale_feature_fusion the
    fuse_ms conv. No other switch moves a 3x3 conv into or out of the
    region."""
    from synergize_motion_appearance_tpu_torch.models.appmotion_former \
        import generator_tap_indices
    from synergize_motion_appearance_tpu_torch.models.vqgan import (
        generator_block_defs,
    )
    n = len(net_cfg["ch_mult"])
    img = net_cfg["img_size"]
    args = (net_cfg["nf"], net_cfg["embed_dim_app"], net_cfg["ch_mult"], 2,
            img, net_cfg["attn_resolutions"])
    defs = generator_block_defs(*args)
    connect = _scales(net_cfg, "connect_list")[1:] if not net_cfg.get(
        "connect_list") else [int(r) for r in net_cfg["connect_list"]]
    taps = {generator_tap_indices(*args)[r] for r in connect}
    convs = Counter()
    ch, res, region = net_cfg["embed_dim_app"], img // 2 ** (n - 1), False
    for i, (kind, out) in enumerate(defs):
        region = (region or kind == "up") and i < len(defs) - 1
        res *= 2 if kind == "up" else 1
        block = {"res": [(ch, out), (out, out)], "up": [(ch, ch)],
                 "conv": [(ch, out)]}.get(kind, [])
        ch = out if kind in ("res", "conv") else ch
        if not region:
            continue
        for cin, cout in block:
            convs[(cin, cout, res)] += 2       # main and low-res streams
        if i in taps and net_cfg.get("multiscale_sft", True):
            convs[(2 * ch, ch, res)] += 1
            convs[(ch, ch, res)] += 5
        if i in taps and net_cfg.get("multiscale_feature_fusion", True):
            convs[(ch, ch, res)] += 1
    return convs


def k3_launch_shapes(net_cfg, batch, dtype):
    """Counter of K3's (B, C, Cout, H, W, dtype) launches in one training
    step: each forward conv of k3_forward_convs and its input gradient
    (the kernel on the channel-swapped weights)."""
    shapes = Counter()
    for (c, co, h), n in k3_forward_convs(net_cfg).items():
        shapes[(batch, c, co, h, h, dtype)] += n
        shapes[(batch, co, c, h, h, dtype)] += n
    return shapes


def _scales(net_cfg, key):
    """The config's list of resolutions ``key``, or every decoder scale."""
    if net_cfg.get(key):
        return [int(r) for r in net_cfg[key]]
    n = len(net_cfg["ch_mult"])
    return [net_cfg["img_size"] // 2 ** (n - 1 - i) for i in range(n)]


def k1_per_train_step(net_cfg):
    """K1 launches of one training forward: self- and cross-attention in
    every transformer layer of the motion pass at the token scale and at
    each connected scale, and of the appearance pass at the token scale
    and at each connected scale up to the largest appearance scale (the
    backward differentiates the plain version and launches none). The
    inference forward launches as many per frame batch. No switch changes
    the count: the switches change what the attention reads (codebook
    rows, position embedding, query), not how often it runs."""
    connect = _scales(net_cfg, "connect_list")
    if not net_cfg.get("connect_list"):
        connect = connect[1:]
    app = 1 + sum(r <= max(_scales(net_cfg, "connect_app_list"))
                  for r in connect)
    return 2 * ((1 + len(connect)) * net_cfg["n_layers_motion"]
                + app * net_cfg["n_layers_app"])


# (B, C, Cout, H, W) on no path, checked and not timed: no tile multiple
# anywhere, H != W, C not a multiple of 8 (NHWC's narrow loads) or of 16
# (a part-filled channel chunk), Cout above one 128-channel tile. The
# first two keep the mma.sync kernel in bf16 (W and C not multiples of 8);
# the others run the wgmma kernel in both layouts: a ragged last chunk of
# 64 channels, a partial row and column tile, W below one tile and above
# two, Cout not a multiple of its 64 or 128 channels.
RAGGED_CONVS = [(1, 3, 5, 7, 9), (3, 20, 40, 17, 33), (2, 72, 130, 31, 64),
                (1, 24, 72, 9, 40), (3, 200, 40, 11, 136)]


def assert_conv_close(torch, out, ref, dtype):
    if dtype == torch.float32:
        # outputs are O(1); the kernel and the plain version sum the same
        # 9*C float32 products in other orders
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        # both accumulate in float32 and round once to bf16: a result on
        # a rounding boundary differs by one bf16 ulp, at most 2^-7 of its
        # magnitude
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-3,
                                   rtol=2 ** -7)


def conv_bound(B, cin, cout, h, w, nbytes, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * B * h * w * 9 * cin * cout / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def device_note(row):
    return (f"  device {row['device_ms']:.4f} ms (wpack "
            f"{row['wpack_device_ms']:.4f}), mma.sync "
            f"{row['mma_device_ms']:.4f} ms, library "
            f"{row['library_device_ms']:.4f} ms" if "device_ms" in row
            else "")


def planned_kernel(f32, row):
    """The kernel ops/conv3x3.py::plan gives a conv on fresh (aligned)
    tensors: float32 the CUDA-core one; bf16 wgmma when an NCHW row (W) or
    an NHWC pixel (C), ``row``, is a whole number of 16-byte units, else
    mma.sync. Every path shape is wgmma's."""
    return "f32" if f32 else "wgmma" if row % 8 == 0 else "mma"


def launched(counter, fn):
    """fn's result and the kernel (a key of ``counter``) it launched."""
    before = Counter(counter)
    out = fn()
    (name,) = (Counter(counter) - before).keys()
    return out, name


def conv_device_times(torch, row, kernel, mma, library):
    """The bf16 device times of a K3 or K4 row at a path shape: the
    planned kernel's (with its weight-packing launch apart), the mma.sync
    kernel's at the same inputs (the kernel before the wgmma one), the
    library call's."""
    times = device_times(torch, kernel)
    row["device_ms"] = sum(times.values())
    row["wpack_device_ms"] = sum(v for k, v in times.items()
                                 if "wpack" in k)
    row["mma_device_ms"] = device_ms(torch, mma)
    row["library_device_ms"] = device_ms(torch, library)


def check_conv3x3(torch, k3, fwd_convs, B):
    """Hold K3 against its plain version at every forward and input-
    gradient shape of one training step, and at RAGGED_CONVS, in float32
    and bfloat16, on the kernel ``plan`` picks (the row's "kernel"); time
    kernel, plain version and the PyTorch call for the same function
    (F.conv2d forward, torch.nn.grad.conv2d_input for the input gradient)
    at the training step's shapes, and in bf16 there the mma.sync kernel
    too, held against the plain version as well."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = Counter()
    for (c, co, h), n in fwd_convs.items():
        cases[("forward", B, c, co, h, h)] += n
        cases[("dgrad", B, co, c, h, h)] += n      # dy (Cout) -> dx (C)
    for bb, c, co, h, w_ in RAGGED_CONVS:
        cases[("forward", bb, c, co, h, w_)] = 0
        cases[("dgrad", bb, co, c, h, w_)] = 0
    rows = []
    for (kind, bb, cin, cout, h, w_), per_step in sorted(
            cases.items(), key=lambda kv: (kv[1] == 0, kv[0])):
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen,
                                            device="cuda")).to(dtype)

            x = randn(bb, cin, h, w_)
            if kind == "forward":
                w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
                b = randn(cout)

                def kernel():
                    return k3.conv3x3(x, w, b)

                def mma():
                    return k3.conv3x3_by("mma", x, w, b)

                def plain():
                    return k3.conv3x3_reference(x, w, b)

                def library():
                    return F.conv2d(x, w, b, padding=1)
            else:  # the conv C=cout -> Cout=cin, differentiated
                w = randn(cin, cout, 3, 3, scale=(9 * cin) ** -0.5)
                b = None

                def kernel():
                    return k3.conv3x3_input_grad(x, w)

                def mma():
                    return k3.conv3x3_by("mma", x, w, flip=True)

                def plain():
                    return k3.conv3x3_reference(x, k3.flipped_weights(w))

                def library():
                    return torch.nn.grad.conv2d_input(
                        (bb, cout, h, w_), w, x, padding=1)

            with torch.no_grad():
                (out, launched_kernel), ref, lib = launched(
                    k3.launch_kernels, kernel), plain(), library()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert_conv_close(torch, out, ref, dtype)
            torch.testing.assert_close(out.float(), lib.float(),
                                       atol=5e-2, rtol=5e-2)
            name = str(dtype).split(".")[1]
            assert launched_kernel == planned_kernel(
                dtype == torch.float32, w_), (kind, launched_kernel)
            row = {"case": kind, "dtype": name, "B": bb, "C": cin,
                   "Cout": cout, "H": h, "W": w_, "kernel": launched_kernel,
                   "launches_per_step": per_step, "max_abs_err": err}
            if per_step and dtype == torch.bfloat16:
                with torch.no_grad():
                    out_mma = mma()
                assert_conv_close(torch, out_mma, ref, dtype)
                row["mma_max_abs_err"] = (
                    out_mma.float() - ref.float()).abs().max().item()
                del out_mma
            if per_step:
                with torch.no_grad():
                    row["ms"] = time_ms(torch, kernel, iters=20)
                    row["plain_ms"] = time_ms(torch, plain, iters=5)
                    row["library_ms"] = time_ms(torch, library, iters=20)
                    if dtype == torch.bfloat16:
                        conv_device_times(torch, row, kernel, mma, library)
                nbytes = (x.numel() + w.numel() + out.numel()
                          + (b.numel() if b is not None else 0)) * \
                    x.element_size()
                row.update(conv_bound(bb, cin, cout, h, w_, nbytes, name))
            rows.append(row)
            print(f"  K3 {kind:7s} {cin:3d}->{cout:3d} @{h:3d}x{w_:<3d} "
                  f"{name:8s} {launched_kernel:5s} x{per_step:2d} "
                  f"max_abs_err {err:.3e}"
                  + (f"  kernel {row['ms']:.4f} ms  plain "
                     f"{row['plain_ms']:.4f} ms  library "
                     f"{row['library_ms']:.4f} ms  bound "
                     f"{row['bound_ms']:.4f} ms" + device_note(row)
                     if per_step else "  (ragged: checked, not timed)"),
                  flush=True)
            del x, w, b, out, ref, lib
    return rows


def check_conv3x3_nhwc(torch, k3, fwd_convs, B):
    """Hold K4 against its plain version at the training step's forward
    3x3 shapes (K3's forward rows) in NHWC with HWIO weights and a float32
    bias, and at RAGGED_CONVS, in float32 and bfloat16, with K3's
    tolerances, on the kernel ``plan`` picks; time kernel, plain version
    and F.conv2d on channels_last tensors (the same function in PyTorch's
    NHWC layout) at the training step's shapes, and in bf16 there the
    mma.sync kernel too, held against the plain version as well. No path
    calls K4."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5432)
    cases = [((B, c, co, h, h), n) for (c, co, h), n in
             sorted(fwd_convs.items())]
    cases += [(shape, 0) for shape in RAGGED_CONVS]
    rows = []
    for (bb, cin, cout, h, w_), per_step in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(bb, h, w_, cin, generator=gen,
                            device="cuda").to(dtype)
            w = ((9 * cin) ** -0.5 * torch.randn(3, 3, cin, cout,
                                                 generator=gen,
                                                 device="cuda")).to(dtype)
            b = torch.randn(cout, generator=gen, device="cuda")
            # the library's NHWC: channels_last NCHW views of the same data
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b_lib = b.to(dtype)

            def kernel():
                return k3.conv3x3_nhwc(x, w, b)

            def mma():
                return k3.conv3x3_nhwc_by("mma", x, w, b)

            def library():
                return F.conv2d(x_cl, w_cl, b_lib, padding=1)

            with torch.no_grad():
                out, launched_kernel = launched(k3.nhwc_launch_kernels,
                                                kernel)
                ref = k3.conv3x3_nhwc_reference(x, w, b)
                lib = library()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert_conv_close(torch, out, ref, dtype)  # K3's bounds
            torch.testing.assert_close(out.float(),
                                       lib.permute(0, 2, 3, 1).float(),
                                       atol=5e-2, rtol=5e-2)
            name = str(dtype).split(".")[1]
            assert launched_kernel == planned_kernel(
                dtype == torch.float32, cin), launched_kernel
            row = {"case": "forward", "dtype": name, "B": bb, "H": h,
                   "W": w_, "C": cin, "Cout": cout, "kernel": launched_kernel,
                   "k3_launches_per_step": per_step, "max_abs_err": err}
            if per_step and dtype == torch.bfloat16:
                with torch.no_grad():
                    out_mma = mma()
                assert_conv_close(torch, out_mma, ref, dtype)
                row["mma_max_abs_err"] = (
                    out_mma.float() - ref.float()).abs().max().item()
                del out_mma
            if per_step:
                with torch.no_grad():
                    row["ms"] = time_ms(torch, kernel, iters=20)
                    row["plain_ms"] = time_ms(
                        torch, lambda: k3.conv3x3_nhwc_reference(x, w, b),
                        iters=5)
                    row["library_ms"] = time_ms(torch, library, iters=20)
                    if dtype == torch.bfloat16:
                        conv_device_times(torch, row, kernel, mma, library)
                nbytes = (x.numel() + w.numel() + out.numel()) * \
                    x.element_size() + b.numel() * 4
                row.update(conv_bound(bb, cin, cout, h, w_, nbytes, name))
            rows.append(row)
            print(f"  K4 {cin:3d}->{cout:3d} @{h:3d}x{w_:<3d} {name:8s} "
                  f"{launched_kernel:5s} max_abs_err {err:.3e}"
                  + (f"  kernel {row['ms']:.4f} ms  plain "
                     f"{row['plain_ms']:.4f} ms  channels_last conv2d "
                     f"{row['library_ms']:.4f} ms  bound "
                     f"{row['bound_ms']:.4f} ms" + device_note(row)
                     if per_step else "  (ragged: checked, not timed)"),
                  flush=True)
            del x, w, b, x_cl, w_cl, b_lib, out, ref, lib
    return rows


def build_report(cuda_build, library, kernel, tc_kernel, no_spill=(),
                 tc_op="HMMA", instances=None):
    """ptxas's registers, shared memory and spills for each kernel of
    csrc/<library>.cu, ptxas's notes on it (such as a serialized wgmma),
    and the tensor-core (HMMA: mma.sync; HGMMA: wgmma) and ldmatrix (LDSM)
    instructions in each kernel's SASS; names are printed from ``kernel``
    on. Every instantiation of the bfloat16 kernel ``tc_kernel`` must hold
    ``tc_op`` instructions, and every kernel whose (mangled) name holds one
    of ``no_spill`` must spill nothing and keep no stack frame (an array
    that ptxas could not keep in registers); with HGMMA, no wgmma of it may
    be serialized (ptxas's C7512 and C7520), and no setmaxnreg of it
    ignored (C7508: the roles' paths reconverge). ``instances``: {name
    substring: count} of the instantiations the library must hold."""
    import re

    kernels, name = {}, None
    for line in cuda_build.build_log(library).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels.setdefault(name, {})
        elif name and "spill" in line:
            kernels[name]["stack_spill"] = line.strip()
        elif name and "Used" in line:
            kernels[name]["ptxas"] = line.split(":", 1)[1].strip()
        m = re.search(r"\((C7\d+)\).*function '(\S+)'", line)
        if m:
            kernels.setdefault(m.group(2), {}).setdefault(
                "notes", []).append(line.split(":", 1)[1].strip()[:160])
    name = None
    for line in cuda_build.sass(library).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels.setdefault(name, {}).update(hmma=0, hgmma=0, ldsm=0)
        elif name:
            kernels[name]["hmma"] += "HMMA" in line
            kernels[name]["hgmma"] += "HGMMA" in line
            kernels[name]["ldsm"] += "LDSM" in line
            if "HMMA" in line and "hmma_example" not in kernels[name]:
                kernels[name]["hmma_example"] = line.strip()[:160]
    for name, k in kernels.items():
        short = name[name.find(kernel):]
        print(f"  {short[:100]}: {k.get('ptxas')}; {k.get('stack_spill')}; "
              f"HMMA {k.get('hmma')}, HGMMA {k.get('hgmma')}, LDSM "
              f"{k.get('ldsm')}" + "".join(f"\n    ptxas: {n}"
                                          for n in k.get("notes", ())),
              flush=True)
        if tc_kernel in name:
            assert k.get(tc_op.lower(), 0) > 0, f"no {tc_op} in {name}"
        if any(s in name for s in no_spill):
            spills = re.findall(r"(\d+) bytes (?:stack frame|spill)",
                                k.get("stack_spill", ""))
            assert spills and not any(int(n) for n in spills), (
                f"spills in {name}: {k.get('stack_spill')}")
            if tc_op == "HGMMA":
                assert not any(c in n for n in k.get("notes", ())
                               for c in ("C7508", "C7512", "C7520")), (
                    f"serialized wgmma or ignored setmaxnreg in {name}: "
                    f"{k['notes']}")
    for part, count in (instances or {}).items():
        got = sum(part in name and "ptxas" in k
                  for name, k in kernels.items())
        assert got == count, f"{library}: {got} instantiations of {part}"
    return kernels


# ---------------------------------------------------------------------------
# pipeline phases
# ---------------------------------------------------------------------------

def frames(n, size, seed):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 255
            ).astype(np.uint8)


def tiny_frames(torch, cfg, ReenactmentPipeline, seeded_nets, fa, seed,
                n_frames):
    """A tiny config's pipeline in float32 on the card (kernel) and on the
    CPU (plain version), same weights and uint8 frames: frames agree
    within 1 level, and K1 ran on the card only. Returns the per-pixel
    differences in levels and the card's K1 launches."""
    src, drv = frames(1, 64, seed + 10), frames(n_frames, 64, seed + 11)
    kw = dict(relative=True, adapt_scale=True, frame_batch=4,
              compute_dtype=torch.float32, u8_io=True)
    outs, launches = {}, {}
    for device in ("cpu", "cuda"):
        g, me = seeded_nets(cfg, seed)
        fa.reset_launches()
        outs[device] = ReenactmentPipeline(g, me, device=device,
                                           **kw).animate(src, drv)
        launches[device] = fa.launches
    assert launches["cpu"] == 0
    assert launches["cuda"] > 0, "tiny run on the card missed K1"
    diff = np.abs(outs["cpu"].astype(np.int32)
                  - outs["cuda"].astype(np.int32))
    assert diff.max() <= 1, f"tiny parity: {diff.max()} levels"
    return diff, launches["cuda"]


def tiny_parity(torch, configs, ReenactmentPipeline, seeded_nets, fa, seed):
    """Tiny config in float32: the card (kernel) against the CPU (plain
    version), same weights and uint8 frames; frames agree within 1 level."""
    diff, launches = tiny_frames(torch, configs.get("tiny"),
                                 ReenactmentPipeline, seeded_nets, fa, seed,
                                 6)
    print(f"parity tiny f32 card vs CPU: max |diff| {diff.max()} levels, "
          f"mean {diff.mean():.4f}, K1 launches {launches}", flush=True)
    return {"max_diff_levels": int(diff.max()),
            "mean_diff_levels": float(diff.mean()),
            "k1_launches": launches}


def main_path(torch, configs, ReenactmentPipeline, seeded_nets, fa, seed,
              card):
    """ReenactmentPipeline.animate at the flagship config, bfloat16,
    relative motion with hull-area scaling, uint8 frames in and out (as
    bench.py runs it). Returns the report and (pipeline, source, driving)
    for the profile phase."""
    cfg = configs.get("flagship_256")
    g, me = seeded_nets(cfg, seed)
    n_params = sum(p.numel() for p in g.parameters()) + sum(
        p.numel() for p in me.parameters())
    pipe = ReenactmentPipeline(g, me, relative=True, adapt_scale=True,
                               frame_batch=FRAME_BATCH,
                               compute_dtype=torch.bfloat16, u8_io=True,
                               device="cuda")
    src = frames(1, 256, seed + 20)
    drv = frames(FRAMES, 256, seed + 21)
    # warm-up (first-call setup), one frame batch whose attention calls'
    # inputs are captured, then held as K1's real-activation case
    captured, launch_k1 = [], fa.fused_attention_packed

    def capture(q, k, v, bias=None, *, num_heads):
        captured.append((q.clone(), k.clone(), v.clone(),
                         None if bias is None else bias.clone(), num_heads))
        return launch_k1(q, k, v, bias, num_heads=num_heads)

    fa.fused_attention_packed = capture
    try:
        pipe.animate(src, drv[:FRAME_BATCH])
    finally:
        fa.fused_attention_packed = launch_k1
    assert len(captured) == 32, f"{len(captured)} attention calls captured"
    captured_rows = check_captured_attention(torch, fa, captured)
    del captured

    # uint8 frames cannot hold a NaN: hold the generator's bf16 output
    # finite on the card (one reduction per frame batch, read afterwards)
    finite = []
    hook = pipe.net_g.register_forward_hook(
        lambda mod, inp, res: finite.append(torch.isfinite(res["out"]).all()))
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.animate(src, drv)
    seconds = time.perf_counter() - t0
    launches, k2_launches = fa.launches, fa.split_launches
    hook.remove()

    n_batches = math.ceil(FRAMES / FRAME_BATCH)
    assert out.shape == (FRAMES, 256, 256, 3), out.shape
    assert out.dtype == np.uint8, out.dtype
    assert len(finite) == n_batches and all(bool(f) for f in finite), (
        "non-finite generator output")
    assert out.std() > 0, "constant frames"
    assert launches == 32 * n_batches, (
        f"K1 launched {launches} times, want 32 per frame batch "
        f"x {n_batches}")
    assert k2_launches == 0, "the reenactment path launched K2"
    fps = FRAMES / seconds
    # two more timed runs, for the spread (launches already read)
    repeats = [seconds]
    for _ in range(2):
        t0 = time.perf_counter()
        pipe.animate(src, drv)
        repeats.append(time.perf_counter() - t0)
    print(f"main path flagship-256 bf16 uint8 io: {FRAMES} frames in "
          f"{seconds:.3f} s = {fps:.2f} frames/s (repeats "
          f"{[round(FRAMES / s, 2) for s in repeats]} frames/s; "
          f"frame_batch {FRAME_BATCH}, {n_params} params) on {card}; "
          f"K1 launches {launches}", flush=True)
    report = {"frames": FRAMES, "frame_batch": FRAME_BATCH,
              "seconds": repeats, "frames_per_s": fps,
              "frames_per_s_repeats": [FRAMES / s for s in repeats],
              "params": n_params, "k1_launches": launches,
              "k2_launches": k2_launches, "k1_captured": captured_rows,
              "out_range": [int(out.min()), int(out.max())],
              "out_std": float(out.std())}
    return report, (pipe, src, drv[:FRAME_BATCH])


def kind_of(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_frame_batch(torch, pipe, src, drv, card):
    """One frame batch of the main path, three times unprofiled (median
    wall time) and once under torch.profiler: device time summed over
    kernels (one stream, so kernels do not overlap), the idle share
    1 - device / unprofiled wall, and device time by kind of kernel."""
    # animate returns host frames: the work is done when it returns
    report = profile(torch, lambda: pipe.animate(src, drv))
    report["frame_batch"] = drv.shape[0]
    print(f"profile, one frame batch of {drv.shape[0]} on {card}: wall "
          f"{report['wall_ms']:.2f} ms ({report['wall_ms_profiled']:.2f} ms "
          f"under the profiler), device {report['device_ms']:.2f} ms, idle "
          f"share {report['idle_share']:.4f}", flush=True)
    print_profile(report)
    return report


def profile(torch, run):
    """``run`` three times unprofiled (median wall time, each ending in a
    synchronize) and once under torch.profiler, summarised by kernel and
    by kind of kernel."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = float(np.median(walls))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a session that loses device activity reruns
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall_profiled_ms = 1e3 * (time.perf_counter() - t0)

        per_kernel = defaultdict(lambda: [0.0, 0])
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            per_kernel[evt.key][0] += us / 1e3
            per_kernel[evt.key][1] += evt.count
        device_ms = sum(v[0] for v in per_kernel.values())
        if device_ms > 0 and not activity_lost(device_ms,
                                               wall_profiled_ms - host_ms):
            break
    assert device_ms > 0, "the profiler saw no device time"
    assert not activity_lost(device_ms, wall_profiled_ms - host_ms), (
        f"the profiler lost device activity: {device_ms:.3f} ms recorded "
        f"where the card still had {wall_profiled_ms - host_ms:.3f} ms of "
        f"queued work when the host had launched it")
    by_kind = defaultdict(float)
    for name, (ms, _) in per_kernel.items():
        by_kind[kind_of(name)] += ms
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": wall_ms, "wall_ms_profiled": wall_profiled_ms,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "kernels": [{"name": n[:200], "kind": kind_of(n), "ms": ms,
                     "calls": c} for n, (ms, c) in ranked],
    }


def print_profile(report):
    for kind, ms in report["by_kind_ms"].items():
        print(f"  {kind:24s} {ms:9.3f} ms")
    for row in report["kernels"][:15]:
        print(f"  {row['ms']:9.3f} ms {row['calls']:5d}x {row['name'][:110]}")


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def train_batch(torch, size, seed, device, n=TRAIN_BATCH):
    """Seeded synthetic uint8 frames as a batch of n (TRAIN_BATCH) (source,
    driving) pairs in [-1, 1], NCHW float32."""
    def to_model(u8):
        x = torch.from_numpy(u8).to(device).float() * (2.0 / 255.0) - 1.0
        return x.permute(0, 3, 1, 2).contiguous()

    return {"source": to_model(frames(n, size, seed)),
            "driving": to_model(frames(n, size, seed + 1))}


def smooth_train_batch(torch, size, seed, n=TRAIN_BATCH):
    """A CPU batch of n (TRAIN_BATCH) image-like (source, driving) pairs in
    [-1, 1], NCHW float32: a seeded 8x8 random field, bilinearly
    upsampled, plus a little noise. White-noise frames blur to nearly
    constant images at the keypoint detector's quarter scale, where
    train-mode BatchNorm divides rounding noise by ~sqrt(eps): the motion
    networks' gradients then differ between the card and the CPU by more
    than compare_updates allows (3.11e-3 against 1.41e-3 on the keypoint
    detector's first conv, on an H100)."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.uniform(-1, 1, (2 * n, 3, 8, 8))
                           .astype(np.float32))
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bilinear")
    img = (img + 0.05 * torch.from_numpy(rng.randn(*img.shape)
                                         .astype(np.float32))).clamp(-1, 1)
    return {"source": img[:n].contiguous(), "driving": img[n:].contiguous()}


def sync_trainer(src, dst):
    """dst's weights (VGG's too), BatchNorm statistics and TrainState
    become src's (from one device to another)."""
    from synergize_motion_appearance_tpu_torch.training import (
        AdamState, TrainState,
    )

    for a, b in ((src.net_g, dst.net_g),
                 (src.motion_estimator, dst.motion_estimator),
                 (src.net_d, dst.net_d), (src.vgg, dst.vgg),
                 (src.vgg_c, dst.vgg_c)):
        b.load_state_dict(a.state_dict())

    def moved(tensors):
        return {k: v.to(dst.device, copy=True) for k, v in tensors.items()}

    st = src.state
    dst.state = TrainState(st.step, moved(st.ema_g), *(
        AdamState(o.count, moved(o.mu), moved(o.nu))
        for o in (st.opt_g, st.opt_m, st.opt_d)))


def train_state(tr):
    """A float32 CPU copy of a trainer's state: each network's weights and
    BatchNorm statistics, the EMA, and the Adam counts and moments."""
    def copied(tensors):
        return {k: v.detach().float().cpu().clone()
                for k, v in tensors.items()}

    st = tr.state
    out = {"g": copied(tr.net_g.state_dict()),
           "m": copied(tr.motion_estimator.state_dict()),
           "d": copied(tr.net_d.state_dict()), "ema": copied(st.ema_g)}
    for name, o in (("g", st.opt_g), ("m", st.opt_m), ("d", st.opt_d)):
        out[name + "_count"] = o.count
        out[name + "_mu"], out[name + "_nu"] = copied(o.mu), copied(o.nu)
    return out


# card vs CPU bounds on one train step's update, as the port's CPU step
# test holds it against the JAX step: gradients per leaf within r of the
# leaf's largest plus a floor of 2e-5 of the network's largest, and within
# 1e-3 relative in each network's 2-norm; r is 1e-3, and for the motion
# networks, whose float32 gradient is ill-conditioned, r is 2e-3 and the
# 2-norm bound 3e-3
GRAD_LEAF_BOUND = {"g": 1e-3, "m": 2e-3, "d": 1e-3}
GRAD_NORM_BOUND = {"g": 1e-3, "m": 3e-3, "d": 1e-3}


def compare_updates(torch, before, cpu, card, lr, betas):
    """Holds the card's step against the CPU's, both from the state
    ``before``: the gradients (gradient_gaps) within GRAD_LEAF_BOUND per
    leaf and, with the second moments' increments, within
    GRAD_NORM_BOUND per network (assert_grad_norms), and the weights,
    BatchNorm statistics and EMA after the update within
    assert_updates_close's bounds. A network whose update was gated off
    keeps its Adam moments bit for bit on both devices. Returns the worst
    relative 2-norm gradient difference."""
    for net in ("g", "m", "d"):
        assert card[net + "_count"] == cpu[net + "_count"], net
        if cpu[net + "_count"] == before[net + "_count"]:  # gated off
            for k in before[net + "_mu"]:
                assert torch.equal(card[net + "_mu"][k], cpu[net + "_mu"][k])
                assert torch.equal(card[net + "_nu"][k], cpu[net + "_nu"][k])
    grads, gaps = gradient_gaps(before, cpu, card, betas)
    for net, gap in gaps.items():
        assert gap["worst_leaf_over_bound"] <= 1.0, (net, gap)
    assert_grad_norms(gaps)
    assert_updates_close(torch, cpu, card, grads, lr)
    return max(gap["rel_norm"] for gap in gaps.values())


def assert_grad_norms(gaps, scale=1.0):
    """Each network's gradient (from the Adam first moments) within
    ``scale`` x GRAD_NORM_BOUND of the reference's in relative 2-norm,
    and the second moments' increments (1 - b2) g^2 within twice that:
    both carry the gradient's scale, which the updates of Adam's first
    steps barely show."""
    for net, gap in gaps.items():
        bound = scale * GRAD_NORM_BOUND[net]
        assert gap["rel_norm"] <= bound, (net, "grad", gap)
        assert gap["nu_rel_norm"] <= 2 * bound, (net, "nu", gap)


def bounds_missed(gaps, shares, min_share=0.999):
    """What of a step misses assert_grad_norms' bounds (gradient_gaps'
    ``gaps``) or assert_updates_close's share (its ``shares``), by
    network or group; empty when the step holds them."""
    missed = {}
    for net, gap in gaps.items():
        bound = GRAD_NORM_BOUND[net]
        if gap["rel_norm"] > bound or gap["nu_rel_norm"] > 2 * bound:
            missed[net] = {k: gap[k] for k in ("rel_norm", "nu_rel_norm")}
    for group, share in shares.items():
        if share < min_share:
            missed.setdefault(group, {})["share"] = share
    return missed


def assert_updates_close(torch, cpu, card, grads, lr, min_share=0.999,
                         shares=None):
    """compare_updates' bounds on the weights, BatchNorm statistics and EMA
    after the update (``grads``: the reference's gradients by network,
    absent where the update was gated off): within 2 lr everywhere, and
    within 1e-6 on at least ``min_share`` of each group's entries whose
    gradient is above the floor (not asserted with ``min_share`` None).
    Returns the smallest such share; each group's goes into the dict
    ``shares`` when one is given."""
    worst = 1.0
    for group in ("g", "m", "d", "ema"):
        want, got = cpu[group], card[group]
        assert sorted(got) == sorted(want), group
        keys = [k for k in want if not k.endswith("num_batches_tracked")]
        for k in want:
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], want[k]), (group, k)
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in keys])
        assert float(diffs.max()) <= 2 * lr * (1 + 1e-3), (group,
                                                          float(diffs.max()))
        g = grads.get("g" if group == "ema" else group)
        if g is None:  # gated off: unchanged on both devices
            assert float(diffs.max()) == 0.0, group
            continue
        floor = 2e-5 * max(float(v.abs().max()) for v in g.values())
        above = torch.cat([g[k].abs().flatten() > floor if k in g
                           else torch.ones(want[k].numel(), dtype=torch.bool)
                           for k in keys])
        close = float((diffs[above] <= 1e-6).float().mean())
        worst = min(worst, close)
        if shares is not None:
            shares[group] = close
        assert min_share is None or close >= min_share, (group, 1 - close)
    return worst


def gradient_gaps(before, ref, other, betas):
    """The gradients of two steps from ``before``, by network, skipping a
    network whose update was gated off. Gradients are recovered from the
    Adam first moments as (mu_t - b1 mu_{t-1}) / (1 - b1). Returns the
    reference's gradients and, per network, the relative 2-norm gap of
    the gradients and of the second moments' increments
    nu_t - b2 nu_{t-1}, and the worst leaf's gradient gap over its bound
    GRAD_LEAF_BOUND x the leaf's largest |gradient| + a floor of 2e-5 x
    the network's largest."""
    b1, b2 = betas

    def rel_norm(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        den = sum(float((b[k] ** 2).sum()) for k in b)
        return (num / max(den, 1e-30)) ** 0.5

    grads, gaps = {}, {}
    for net in ("g", "m", "d"):
        mu0, nu0 = before[net + "_mu"], before[net + "_nu"]
        if ref[net + "_count"] == before[net + "_count"]:  # gated off
            continue
        g = {side: {k: (st[net + "_mu"][k] - b1 * mu0[k]) / (1 - b1)
                    for k in mu0} for side, st in (("ref", ref),
                                                   ("other", other))}
        dnu = {side: {k: st[net + "_nu"][k] - b2 * nu0[k] for k in nu0}
               for side, st in (("ref", ref), ("other", other))}
        grads[net] = g["ref"]
        floor = 2e-5 * max(float(v.abs().max()) for v in g["ref"].values())
        leaf = max((float((g["other"][k] - w).abs().max())
                    / (GRAD_LEAF_BOUND[net] * float(w.abs().max()) + floor),
                    k) for k, w in g["ref"].items())
        gaps[net] = {"rel_norm": rel_norm(g["other"], g["ref"]),
                     "nu_rel_norm": rel_norm(dnu["other"], dnu["ref"]),
                     "worst_leaf_over_bound": leaf[0], "worst_leaf": leaf[1]}
    return grads, gaps


def tiny_train_parity(torch, configs, Trainer, sample_random_tps, k3, seed):
    """TINY_TRAIN in float32 from one seed, three steps on both devices
    with the same image-like batch (smooth_train_batch) and TPS warps; net_d_start_iter 1, so the third
    step runs the D phase and the adaptive weight. Before each step the
    card's trainer takes the CPU's state, so each step is compared from
    one state: at initialisation the codebook entries are ~1/K, so which
    entry is nearest to an embedding is decided in the last bits of its
    distances, and the two devices' rounding picks other entries for some
    embeddings, after which the trajectories part. Every log agrees
    within rtol 1e-3 + atol 1e-4: the card sums convolutions and attention
    in other orders than the CPU (~1e-6 relative per layer), and a nearest
    entry picked differently moves the motion-codebook losses. After each
    step the updates are held against each other too (compare_updates):
    the gradients, which on the card run through K3's input gradient, the
    Adam moments, and the weights, BatchNorm statistics and EMA after the
    update."""
    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 1
    gen = torch.Generator().manual_seed(seed + 30)
    tp = cfg["train"]["equivariance_opt"]["transform_params"]
    warps = [sample_random_tps(gen, TRAIN_BATCH, tp["sigma_affine"],
                               tp["sigma_tps"], tp["points_tps"])
             for _ in range(3)]
    trainers = {d: Trainer(cfg, device=d, seed=seed) for d in ("cpu", "cuda")}
    batch = smooth_train_batch(torch, 64, seed + 31)
    batches = {d: {k: v.to(d) for k, v in batch.items()} for d in trainers}
    logs = {d: [] for d in trainers}
    launches = {d: 0 for d in trainers}
    betas = [float(b) for b in cfg["train"]["optim_g"]["betas"]]
    worst_grad = 0.0
    for w in warps:
        sync_trainer(trainers["cpu"], trainers["cuda"])
        before = train_state(trainers["cpu"])
        step = trainers["cpu"].state.step
        lr = max(f(step) for f in (trainers["cpu"].lr_g,
                                   trainers["cpu"].lr_m,
                                   trainers["cpu"].lr_d))
        for d, tr in trainers.items():
            k3.reset_launches()
            logs[d].append({k: float(v) for k, v in
                            tr.train_step(batches[d], tps=w).items()})
            launches[d] += k3.launches
        worst_grad = max(worst_grad, compare_updates(
            torch, before, train_state(trainers["cpu"]),
            train_state(trainers["cuda"]), lr, betas))
    assert launches["cpu"] == 0
    assert launches["cuda"] > 0, "tiny training on the card missed K3"
    worst = 0.0
    for cpu, card in zip(logs["cpu"], logs["cuda"]):
        assert sorted(cpu) == sorted(card)
        for k, v in cpu.items():
            err = abs(card[k] - v)
            worst = max(worst, err / (abs(v) + 1e-1))
            assert err <= 1e-3 * abs(v) + 1e-4, (k, card[k], v)
    assert logs["cuda"][2]["d_weight"] > 0, "the third step runs the probe"
    print(f"parity tiny train f32 card vs CPU, 3 steps, each from the CPU's "
          f"state: logs worst |diff| / (|cpu| + 0.1) {worst:.3e}; gradients "
          f"worst relative 2-norm diff {worst_grad:.3e}; weights, statistics,"
          f" EMA and Adam moments within bounds; K3 launches "
          f"{launches['cuda']}",
          flush=True)
    return {"steps": 3, "worst_rel_diff": worst,
            "worst_grad_rel_norm_diff": worst_grad,
            "k3_launches": launches["cuda"], "logs_cuda": logs["cuda"],
            "logs_cpu": logs["cpu"]}


def train_path(torch, configs, Trainer, fa, k3, seed, card):
    """Trainer.train_step at FLAGSHIP_TRAIN (options/train.yml: 256^2,
    batch 2, bf16 compute with f32 master weights) on seeded random
    weights and seeded synthetic frames, with net_d_start_iter 1 so that
    the D phase and the adaptive weight run from the third step. One
    warm-up step, then TRAIN_STEPS timed steps, each with the kernel
    counts reset just before it and read just after."""
    cfg = configs.get("flagship_train")
    cfg["train"]["net_d_start_iter"] = 1
    g_cfg = cfg["network_g"]
    k3_per_step = 2 * sum(k3_forward_convs(g_cfg).values())  # fwd + dgrad
    k1_per_step = k1_per_train_step(g_cfg)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda", seed=seed)
    setup_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in (
        ("net_g", tr.net_g), ("motion_estimator", tr.motion_estimator),
        ("net_d", tr.net_d), ("vgg", tr.vgg))}
    batch = train_batch(torch, 256, seed + 40, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)

    def snapshot(module):
        return [p.detach().clone() for p in module.parameters()]

    def moved(before, module):
        return any(not torch.equal(a, b)
                   for a, b in zip(before, module.parameters()))

    g0, m0, d0 = snapshot(tr.net_g), snapshot(tr.motion_estimator), \
        snapshot(tr.net_d)
    torch.cuda.reset_peak_memory_stats()
    steps = [{"logs": {k: float(v) for k, v in
                       tr.train_step(batch, generator=gen).items()}}]
    for _ in range(TRAIN_STEPS):
        if tr.state.step == 2:
            d_pre = snapshot(tr.net_d)
        fa.reset_launches()
        k3.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = tr.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        steps.append({"ms": ms, "k1_launches": fa.launches,
                      "k2_launches": fa.split_launches,
                      "k3_launches": k3.launches,
                      "k4_launches": k3.nhwc_launches,
                      "k3_shapes": dict(k3.launch_shapes),
                      "k3_kernels": dict(k3.launch_kernels),
                      "logs": {k: float(v) for k, v in logs.items()}})
    peak = torch.cuda.max_memory_allocated()

    for i, st in enumerate(steps):
        for k, v in st["logs"].items():
            assert math.isfinite(v), f"step {i}: {k} = {v}"
        assert st["logs"]["step_skipped_nonfinite"] == 0.0, f"step {i}"
        assert (st["logs"]["d_weight"] > 0) == (i >= 2), (
            f"step {i}: d_weight {st['logs']['d_weight']}")
    timed = steps[1:]
    for st in timed:
        assert st["k1_launches"] == k1_per_step, (st["k1_launches"],
                                                  k1_per_step)
        assert st["k3_launches"] == k3_per_step, (st["k3_launches"],
                                                  k3_per_step)
        assert st["k3_kernels"] == {"wgmma": k3_per_step}, st["k3_kernels"]
        assert st["k2_launches"] == st["k4_launches"] == 0, st
    assert Counter(timed[-1]["k3_shapes"]) == k3_launch_shapes(
        g_cfg, TRAIN_BATCH, "bfloat16"), (
        "K3 ran at other shapes than the config's decoder region")
    assert moved(g0, tr.net_g) and moved(m0, tr.motion_estimator), (
        "G or M did not move")
    assert not any(not torch.equal(a, b) for a, b in zip(d0, d_pre)), (
        "D moved before its onset")
    assert moved(d_pre, tr.net_d), "D did not move after its onset"

    ms = [st["ms"] for st in timed]
    med = float(np.median(ms))
    report = {
        "config": "flagship_train (options/train.yml), net_d_start_iter 1",
        "batch": TRAIN_BATCH, "size": 256, "setup_s": setup_s,
        "params": n_params, "step_ms": ms, "step_ms_median": med,
        "step_ms_min": min(ms), "step_ms_max": max(ms),
        "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "max_memory_allocated_bytes": peak,
        "k1_launches_per_step": k1_per_step,
        "k3_launches_per_step": k3_per_step,
        "k3_kernels_per_step": timed[-1]["k3_kernels"],
        "k1_launches": sum(st["k1_launches"] for st in timed),
        "k3_launches": sum(st["k3_launches"] for st in timed),
        "k2_launches": sum(st["k2_launches"] for st in timed),
        "k4_launches": sum(st["k4_launches"] for st in timed),
        "steps": [{k: v for k, v in st.items() if k != "k3_shapes"}
                  for st in steps],
    }
    print(f"train path flagship_train (options/train.yml; net_d_start_iter "
          f"set to 1) bf16, batch {TRAIN_BATCH} at 256^2 on {card}: "
          f"{TRAIN_STEPS} steps after 1 warm-up, median {med:.2f} ms/step "
          f"(min {min(ms):.2f}, max {max(ms):.2f}) = "
          f"{report['samples_per_s']:.3f} samples/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; K1 {k1_per_step} and K3 "
          f"{k3_per_step} launches per step (K3 by kernel "
          f"{timed[-1]['k3_kernels']}); set-up {setup_s:.1f} s; "
          f"params {n_params}", flush=True)
    print(f"  last step logs: "
          f"{ {k: round(v, 5) for k, v in timed[-1]['logs'].items()} }",
          flush=True)
    return report, (tr, batch, gen)


def profile_train_step(torch, tr, batch, gen, card):
    """One training step of the train path, profiled as a frame batch of
    the reenactment path is."""
    report = profile(torch, lambda: tr.train_step(batch, generator=gen))
    print(f"profile, one flagship train step (batch {TRAIN_BATCH}) on "
          f"{card}: wall {report['wall_ms']:.2f} ms "
          f"({report['wall_ms_profiled']:.2f} ms under the profiler), device "
          f"{report['device_ms']:.2f} ms, idle share "
          f"{report['idle_share']:.4f}", flush=True)
    print_profile(report)
    return report


# ---------------------------------------------------------------------------
# the training entry point
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the ablation switches of the generator, keypoint detector and dense motion
# ---------------------------------------------------------------------------

# The paper's ablations, as tests/test_torch_switches.py's VARIANTS: each a
# dict of overrides of network_g ("g"), the keypoint detector ("kp") or the
# dense-motion network ("dm"). The tiny config's 2-stage hourglass cannot
# feed occlusion_num 5 - 2 direct heads, so its multi_mask variant takes 3
# stages (TINY_ABLATIONS); the flagship's 5 stages can.
ABLATIONS = {
    "no_position_emb": {"g": {"with_position_emb": False}},
    "no_warp_query": {"g": {"warp_s_d_kp_query": False}},
    "no_mrfa": {"g": {"MRFA_motion_enc": False}},
    "no_warp_query_no_mrfa": {"g": {"warp_s_d_kp_query": False,
                                    "MRFA_motion_enc": False}},
    "whole_motion_book": {"g": {"motion_codebook_split": False}},
    "disjoint_motion_books": {"g": {"wo_motion_cdbk_share": True}},
    "whole_app_book": {"g": {"app_codebook_split": False}},
    "disjoint_app_books": {"g": {"wo_app_cdbk_share": True}},
    "no_sft": {"g": {"multiscale_sft": False}},
    "no_feature_fusion": {"g": {"multiscale_feature_fusion": False}},
    "multi_mask": {"dm": {"multi_mask": True, "occlusion_num": 5}},
    "no_jacobian": {"kp": {"estimate_jacobian": False}},
    "single_jacobian_map": {"kp": {"single_jacobian_map": True}},
}
TINY_ABLATIONS = {"multi_mask": {"dm": {"num_blocks": 3}}}
# variants whose attention reads other codebook rows or no position
# embedding: their captured K1 inputs are held against the plain version
NEW_K1_INPUTS = ("no_position_emb", "whole_motion_book",
                 "disjoint_motion_books", "whole_app_book",
                 "disjoint_app_books")


# The tiny step's gradients against the CPU's, in 2-norm, at this many
# times GRAD_NORM_BOUND. One float32 step of a variant can be far less
# well conditioned than the default's: on an NVIDIA H100 80GB HBM3 at
# 700 W whole_motion_book's motion-network gradient lay 1.62e-2 from the
# CPU's, and no_sft's discriminator gradient 1.10e-3, though the two
# devices' logs agreed within 2e-6; on the CPU the same variant's
# generator gradient lies 1.7e-3 from the JAX package's fed the same
# dense motion (2e-3 of its deformation gradient, spread over every
# pixel), and scaling the default config's input by 1 + 2^-22 moves its
# motion and discriminator gradients by 3.4e-3 and 8.1e-3. So one step
# across devices cannot be held at GRAD_NORM_BOUND; a missing term or a
# wrong scale moves a network's gradient by order 1.
ABLATION_NORM_SCALE = 10


def ablation_cfg(cfg, name, tiny=False):
    """``cfg`` (a network or training config) with variant ``name``'s
    switches (ABLATIONS) or head widths (HEAD_WIDTHS); without Jacobians
    the equivariance loss drops its Jacobian term (use_jacobian false),
    which it could not compute."""
    for ov in ({**ABLATIONS, **HEAD_WIDTHS}[name],
               TINY_ABLATIONS.get(name, {}) if tiny
               else {}):
        cfg["network_g"].update(ov.get("g", {}))
        me = cfg["network_motion_estimator"]
        me["kp_detector_params"].update(ov.get("kp", {}))
        me["dense_motion_params"].update(ov.get("dm", {}))
    kp = cfg["network_motion_estimator"]["kp_detector_params"]
    if "train" in cfg and not kp.get("estimate_jacobian", True):
        cfg["train"]["equivariance_opt"]["use_jacobian"] = False
    return cfg


def ablation_tiny(torch, configs, ReenactmentPipeline, seeded_nets, Trainer,
                  sample_random_tps, fa, k3, name, seed):
    """Variant ``name`` at the tiny config in float32: the pipeline's
    uint8 frames on the card within 1 level of the CPU's (K1 launched on
    the card only), and one training step (D and the adaptive weight on)
    from one state on both devices, with logs within tiny_train_parity's
    bounds (K3 launched on the card only), and the updated weights,
    statistics and EMA within 2 lr (assert_updates_close). Each
    network's gradient and second moments' increment are held in 2-norm
    at ABLATION_NORM_SCALE times compare_updates' bounds; the gaps, the
    worst leaf against the per-leaf bound and the share of updated
    entries within 1e-6 are reported. The step compared is the second:
    at step 0 the motion networks' float32 gradient is at its worst
    conditioned (tests/test_torch_train_step.py measures it)."""
    diff, k1_launches = tiny_frames(
        torch, ablation_cfg(configs.get("tiny"), name, tiny=True),
        ReenactmentPipeline, seeded_nets, fa, seed, 4)

    tcfg = ablation_cfg(configs.get("tiny_train"), name, tiny=True)
    tcfg["train"]["net_d_start_iter"] = -1  # D and the probe in the step
    tp = tcfg["train"]["equivariance_opt"]["transform_params"]
    warp = sample_random_tps(torch.Generator().manual_seed(seed + 30),
                             TRAIN_BATCH, tp["sigma_affine"], tp["sigma_tps"],
                             tp["points_tps"])
    trainers = {d: Trainer(tcfg, device=d, seed=seed) for d in ("cpu",
                                                                "cuda")}
    batch = smooth_train_batch(torch, 64, seed + 31)
    trainers["cpu"].train_step(batch, tps=warp)  # step 0, on the CPU
    sync_trainer(trainers["cpu"], trainers["cuda"])
    before = train_state(trainers["cpu"])
    logs, k3_launches = {}, {}
    for d, tr in trainers.items():
        k3.reset_launches()
        logs[d] = {k: float(v) for k, v in tr.train_step(
            {k: v.to(d) for k, v in batch.items()}, tps=warp).items()}
        k3_launches[d] = k3.launches
    assert k3_launches["cpu"] == 0 and k3_launches["cuda"] > 0, k3_launches
    assert sorted(logs["cpu"]) == sorted(logs["cuda"])
    for k, v in logs["cpu"].items():
        assert abs(logs["cuda"][k] - v) <= 1e-3 * abs(v) + 1e-4, (
            name, k, logs["cuda"][k], v)
    assert logs["cuda"]["d_weight"] > 0, name
    lr = max(f(1) for f in (trainers["cpu"].lr_g, trainers["cpu"].lr_m,
                            trainers["cpu"].lr_d))
    betas = [float(b) for b in tcfg["train"]["optim_g"]["betas"]]
    cpu, card = train_state(trainers["cpu"]), train_state(trainers["cuda"])
    for net in ("g", "m", "d"):
        assert card[net + "_count"] == cpu[net + "_count"], net
    grads, gaps = gradient_gaps(before, cpu, card, betas)
    assert_grad_norms(gaps, scale=ABLATION_NORM_SCALE)
    share = assert_updates_close(torch, cpu, card, grads, lr, min_share=None)
    leaf = max((g["worst_leaf_over_bound"], g["worst_leaf"])
               for g in gaps.values())
    return {"max_diff_levels": int(diff.max()), "k1_launches": k1_launches,
            "train_k3_launches": k3_launches["cuda"],
            "worst_grad_rel_norm_diff": max(g["rel_norm"]
                                            for g in gaps.values()),
            "worst_grad_net": max(gaps, key=lambda n: gaps[n]["rel_norm"]),
            "grad_gaps": gaps,
            "worst_leaf_over_bound": leaf[0], "worst_leaf": leaf[1],
            "updated_share_within_1e6": share}


def ablation_inference(torch, configs, ReenactmentPipeline, seeded_nets, fa,
                       name, seed, dtype=None, capture=False):
    """Variant ``name``'s flagship-256 networks in one frame batch (bf16,
    or ``dtype``) of FRAME_BATCH uint8 frames (relative motion, hull-area
    scaling): a
    warm-up batch, whose attention inputs are captured for the variants
    of NEW_K1_INPUTS (and with ``capture``), then a timed one with the
    kernel counts reset just before it. Frames finite (the generator's output), K1 as the config
    says. Returns the row and the captured inputs."""
    cfg = ablation_cfg(configs.get("flagship_256"), name)
    g, me = seeded_nets(cfg, seed)
    pipe = ReenactmentPipeline(g, me, relative=True, adapt_scale=True,
                               frame_batch=FRAME_BATCH,
                               compute_dtype=dtype or torch.bfloat16,
                               u8_io=True, device="cuda")
    src = frames(1, 256, seed + 20)
    drv = frames(FRAME_BATCH, 256, seed + 21)
    captured, launch_k1 = [], fa.fused_attention_packed
    if capture or name in NEW_K1_INPUTS:
        def capture_k1(q, k, v, bias=None, *, num_heads):
            captured.append((q.clone(), k.clone(), v.clone(),
                             None if bias is None else bias.clone(),
                             num_heads))
            return launch_k1(q, k, v, bias, num_heads=num_heads)

        fa.fused_attention_packed = capture_k1
    try:
        pipe.animate(src, drv)
    finally:
        fa.fused_attention_packed = launch_k1
    finite = []
    hook = pipe.net_g.register_forward_hook(
        lambda mod, inp, res: finite.append(torch.isfinite(res["out"]).all()))
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.animate(src, drv)
    seconds = time.perf_counter() - t0
    launches = fa.launches
    hook.remove()
    want = k1_per_train_step(cfg["network_g"])
    assert out.shape == (FRAME_BATCH, 256, 256, 3) and out.dtype == np.uint8
    assert len(finite) == 1 and bool(finite[0]), f"{name}: non-finite frames"
    assert out.std() > 0, f"{name}: constant frames"
    assert launches == want, (name, launches, want)
    assert fa.split_launches == 0
    return {"frames_per_s": FRAME_BATCH / seconds, "batch_ms": 1e3 * seconds,
            "k1_launches": launches}, captured


def ablation_train(torch, configs, Trainer, fa, k3, name, seed):
    """One flagship train step of variant ``name`` (options/train.yml with
    its switches: 256^2, batch TRAIN_BATCH, bf16) with D on: a warm-up
    step 0, then step 1 (net_d_start_iter 0) timed, with the kernel counts
    reset just before it. Logs finite, D's weight on, K1 and K3 launches
    and K3's shapes as the config says."""
    cfg = ablation_cfg(configs.get("flagship_train"), name)
    cfg["train"]["net_d_start_iter"] = 0
    g_cfg = cfg["network_g"]
    tr = Trainer(cfg, device="cuda", seed=seed)
    batch = train_batch(torch, 256, seed + 40, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    tr.train_step(batch, generator=gen)
    fa.reset_launches()
    k3.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = tr.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    k1_launches, k3_launches = fa.launches, k3.launches
    shapes = Counter(k3.launch_shapes)
    logs = {k: float(v) for k, v in logs.items()}
    for k, v in logs.items():
        assert math.isfinite(v), (name, k, v)
    assert logs["step_skipped_nonfinite"] == 0.0, name
    assert logs["d_weight"] > 0, (name, logs["d_weight"])
    assert k1_launches == k1_per_train_step(g_cfg), (name, k1_launches)
    assert k3_launches == 2 * sum(k3_forward_convs(g_cfg).values()), (
        name, k3_launches)
    assert shapes == k3_launch_shapes(g_cfg, TRAIN_BATCH, "bfloat16"), (
        f"{name}: K3 at other shapes")
    return {"step_ms": ms, "k1_launches": k1_launches,
            "k3_launches": k3_launches, "logs": logs}


def ablations(torch, configs, ReenactmentPipeline, seeded_nets, Trainer,
              sample_random_tps, fa, k3, seed, card):
    """Every ablation variant (ABLATIONS): tiny parity (ablation_tiny),
    one full-width frame batch (ablation_inference) and one full-width
    train step (ablation_train), and K1 held against its plain version on
    the captured attention inputs of the variants that read other
    codebook rows or no position embedding."""
    t_phase = time.perf_counter()
    report = {}
    for name in ABLATIONS:
        t0 = time.perf_counter()
        row = {"tiny": ablation_tiny(
            torch, configs, ReenactmentPipeline, seeded_nets, Trainer,
            sample_random_tps, fa, k3, name, seed)}
        row["inference"], captured = ablation_inference(
            torch, configs, ReenactmentPipeline, seeded_nets, fa, name, seed)
        if captured:
            row["k1_captured"] = check_captured_attention(
                torch, fa, captured, f"one {name} frame batch")
        del captured
        row["train"] = ablation_train(torch, configs, Trainer, fa, k3, name,
                                      seed)
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        report[name] = row
        inf, trn, tiny = row["inference"], row["train"], row["tiny"]
        print(f"ablation {name}: flagship-256 bf16 {inf['frames_per_s']:.2f} "
              f"frames/s (one frame batch of {FRAME_BATCH}, K1 "
              f"{inf['k1_launches']}), train step batch {TRAIN_BATCH} "
              f"{trn['step_ms']:.2f} ms (K1 {trn['k1_launches']}, K3 "
              f"{trn['k3_launches']}) on {card}; tiny f32 card vs CPU "
              f"{tiny['max_diff_levels']} levels, train step gradients "
              f"{tiny['worst_grad_rel_norm_diff']:.3e} relative 2-norm "
              f"({tiny['worst_grad_net']}), "
              f"worst leaf {tiny['worst_leaf_over_bound']:.2f} of its bound "
              f"({tiny['worst_leaf']}), updated entries within 1e-6 "
              f"{tiny['updated_share_within_1e6']:.4f}; "
              f"{row['seconds']:.1f} s", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"ablations: {len(ABLATIONS)} variants in {wall:.1f} s on {card}",
          flush=True)
    return {"variants": report, "wall_s": wall}


# ---------------------------------------------------------------------------
# attention at every head width the JAX package takes
# ---------------------------------------------------------------------------

# n_head values of the flagship generator past the shipped 8 (every
# TransformerLayer takes the one n_head): 1 gives the appearance
# transformer d = 256 and the motion one d = 32, 2 gives 128 and 16, 32
# gives 8 and 1
HEAD_COUNTS = (1, 2, 32)
# overrides of network_g, as ABLATIONS: the flagship at each n_head, and
# the tiny config's variant with motion d = 1 and appearance d = 128
# (tests/test_torch_attention_widths.py holds it against the JAX package)
HEAD_WIDTHS = {f"n_head_{h}": {"g": {"n_head": h}} for h in HEAD_COUNTS}
HEAD_WIDTHS["tiny_d1_d128"] = {"g": {
    "n_head": 4, "embed_dim_motion": 4, "dim_embd_motion": 4,
    "embed_dim_app": 512, "dim_embd_app": 512}}
# the flagship at n_head 2 with a 192-wide appearance transformer
# (appearance d = 96: the d = 128 wgmma design at D = 96), and the tiny
# config at n_head 1 with a 320-wide one (appearance d = 320: the float32
# wide kernel at C = 384)
HEAD_WIDTHS["app_d96"] = {"g": {"n_head": 2, "embed_dim_app": 192,
                                "dim_embd_app": 192}}
HEAD_WIDTHS["tiny_d320"] = {"g": {"n_head": 1, "embed_dim_app": 320,
                                  "dim_embd_app": 320}}
# the flagship at n_head 1 with a 384-wide appearance transformer
# (appearance d = 384: the d = 512 wgmma design at W = 192), and the tiny
# config at n_head 1 with a 640-wide one (appearance d = 640: the float32
# wide kernel at C = 640)
HEAD_WIDTHS["app_d384"] = {"g": {"n_head": 1, "embed_dim_app": 384,
                                 "dim_embd_app": 384}}
HEAD_WIDTHS["tiny_d640"] = {"g": {"n_head": 1, "embed_dim_app": 640,
                                  "dim_embd_app": 640}}
# (name, B, L, E, H, K, shared context, bias, 0): a width for each
# instantiation of the d = 128, d = 256 and d = 512 wgmma designs in bf16
# (D = 96 at d = 72 and 96, D = 128 on 4-d maps at 112, on 3-d maps at
# 128; D = 160, 224 and 256 on 4-d maps at 160, 224 and 248, on 3-d maps
# at 256; D = 192 at TIMED_WIDTHS; W = 160 at d = 264, 288 and 320, 192
# at 384, 224 at 448, 256 at 504 and 512) and of the float32 wide kernel
# (C = 128 to 1024 at d = 72 to 1024); d = 161, off 16-byte rows (the
# d-chunked kernel in bf16 and both kernels' element-wise copies); bf16
# above 512 and float32 d = 1032, past the wide kernel (the d-chunked
# kernels, K1 and K2 both); d = 512 on a shared codebook; L and K off the
# query and key tiles, each with a bias that masks every key of batch row
# 0; checked, and timed where the d-chunked kernels run them (on no frame
# batch)
RAGGED_WIDTHS = [
    ("ragged_L1000_K700_d96", 4, 1000, 192, 2, 700, False, True, 0),
    ("ragged_L1000_K700_d72", 4, 1000, 144, 2, 700, False, True, 0),
    ("ragged_L1000_K700_d112", 4, 1000, 224, 2, 700, False, True, 0),
    ("ragged_L900_K333_d160", 3, 900, 160, 1, 333, False, True, 0),
    ("ragged_L900_K333_d161", 3, 900, 322, 2, 333, True, True, 0),
    ("ragged_L900_K333_d224", 3, 900, 224, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d248", 3, 1000, 248, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d128", 3, 1000, 256, 2, 333, True, True, 0),
    ("ragged_L1000_K333_d256", 3, 1000, 256, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d320", 3, 1000, 320, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d384", 3, 1000, 384, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d448", 3, 1000, 448, 1, 333, False, True, 0),
    ("ragged_L1000_K333_d512", 3, 1000, 512, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d264", 3, 1000, 264, 1, 333, False, True, 0),
    ("ragged_L900_K333_d288", 3, 900, 576, 2, 333, False, True, 0),
    ("ragged_L1000_K333_d504", 3, 1000, 504, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d520", 3, 1000, 520, 1, 333, False, True, 0),
    ("ragged_L1000_K333_d640", 3, 1000, 640, 1, 333, True, True, 0),
    ("ragged_L900_K333_d712", 3, 900, 712, 1, 333, False, True, 0),
    ("ragged_L1000_K333_d776", 3, 1000, 776, 1, 333, False, True, 0),
    ("ragged_L1000_K333_d1024", 3, 1000, 1024, 1, 333, True, True, 0),
    ("ragged_L1000_K333_d1032", 3, 1000, 1032, 1, 333, False, True, 0),
]
# (name, B, L, E, H, K, shared context, bias, dtype): one appearance
# launch of a flagship frame batch (B 16, L = K = 1024, its key bias on)
# at widths the d-chunked kernels served before: bf16 d = 96 (E 192 at
# n_head 2: the d = 128 wgmma design at D = 96), bf16 d = 192 (E 384 at
# n_head 2: the d = 256 design at D = 192), float32 d = 320 (E 320 at
# n_head 1: the float32 wide kernel at C = 384), bf16 d = 384 (E 384 at
# n_head 1: the d = 512 design at W = 192) and float32 d = 640 (E 640 at
# n_head 1 against a shared (512, 640) codebook: the float32 wide kernel
# at C = 640); checked in both layouts, timed against the d-chunked kernel
# and SDPA
TIMED_WIDTHS = [
    ("frame_E192_H2_d96", FRAME_BATCH, 1024, 192, 2, 1024, False, True,
     "bfloat16"),
    ("frame_E384_H2_d192", FRAME_BATCH, 1024, 384, 2, 1024, False, True,
     "bfloat16"),
    ("frame_E320_H1_d320", FRAME_BATCH, 1024, 320, 1, 1024, False, True,
     "float32"),
    ("frame_E384_H1_d384", FRAME_BATCH, 1024, 384, 1, 1024, False, True,
     "bfloat16"),
    ("frame_E640_H1_K512_d640", FRAME_BATCH, 1024, 640, 1, 512, True, True,
     "float32"),
]
WIDTHS_TIMEOUT = 300  # seconds for the phase's process


def head_width_kernels(torch, fa, H, sms, E_app=256):
    """The kernel that plan names for each of the 32 attention calls of
    one flagship frame batch at n_head H and appearance width E_app (the
    motion calls in float32, the appearance ones in bfloat16, pointers
    aligned), counted: a Counter."""
    want = Counter()
    for name, B, L, E, hh, K, _, _, per in attention_cases(
            FRAME_BATCH, H=H, E_app=E_app):
        dtype = torch.float32 if name.startswith("motion") else \
            torch.bfloat16
        want[fa.plan(dtype, B, hh, L, E // hh, sms, 0, 0, 0, 0).kernel] += per
    return want


def width_halves(rows, weight="launches_per_frame_batch"):
    """Device sums per frame batch of the timed rows of one n_head (K1's,
    or K2's with ``weight`` "k1_launches_per_frame_batch"), by transformer
    half (appearance, motion), dtype and kernel: the kernel's, SDPA's and
    the bound's, with the bound's share."""
    halves = {}
    for r in rows:
        if not r[weight] or "device_ms" not in r:
            continue
        half = "motion" if r["case"].startswith("motion") else "appearance"
        h = halves.setdefault(f"{half}_{r['dtype']}_d{r['d']}_{r['kernel']}",
                              Counter())
        for key in ("device_ms", "library_device_ms", "bound_ms"):
            h[key] += r[key] * r[weight]
        h["launches"] += r[weight]
    for h in halves.values():
        h["bound_share"] = h["bound_ms"] / h["device_ms"]
    return {key: dict(h) for key, h in halves.items()}


def forced_kernel(fa, p, num_heads=None):
    """K1 (num_heads given) or K2 on kernel plan ``p``, whatever plan
    picks: the plan replaced for the call."""
    def call(q, k, v, bias):
        with mock.patch.object(fa, "plan", return_value=p):
            if num_heads is None:
                return fa.fused_attention(q, k, v, bias)
            return fa.fused_attention_packed(q, k, v, bias,
                                             num_heads=num_heads)
    return call


def timed_widths(torch, fa, rate, card):
    """At each TIMED_WIDTHS shape, in its dtype: K1 on the kernel plan
    picks and on the d-chunked kernel forced through plan, each held
    against the plain version; K2 on plan's kernel from the head-split
    view of the same tensors (x.view(B, L, H, d).transpose(1, 2)), held
    against its plain version; the profiler's device time of plan's
    kernel and of the d-chunked one in turns (a, b, b, a), SDPA's, K2's
    (on contiguous head-split copies), the events' and the plain
    version's as attention_times takes them, and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3456)
    rows = []
    for name, B, L, E, H, K, shared, _, dtype_name in TIMED_WIDTHS:
        dtype = getattr(torch, dtype_name)
        d = E // H
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
            dtype) for shape in ((B, L, E),) + 2 * (
                ((K, E),) if shared else ((B, K, E),)))
        bias = random_bias(torch, gen, B, K)
        heads = [t.view(-1, t.shape[-2], H, d).transpose(1, 2)
                 for t in (q, k, v)]
        chunked = forced_kernel(fa, fa.Plan("chunked",
                                            fa.CHUNKED_ROWS[dtype]), H)
        before = fa.launch_kernels.copy()
        with torch.no_grad():
            out = fa.fused_attention_packed(q, k, v, bias, num_heads=H)
            kernel = launched_kernel(fa, before)
            out_chunked = chunked(q, k, v, bias)
            out_k2 = fa.fused_attention(*heads, bias)
            ref = fa.fused_attention_packed_reference(q, k, v, bias,
                                                      num_heads=H)
            ref_k2 = fa.fused_attention_reference(*heads, bias)
        torch.cuda.synchronize()
        for got, want in ((out, ref), (out_chunked, ref), (out_k2, ref_k2)):
            assert_attention_close(torch, got, want, True)
        row = {"case": name, "dtype": dtype_name, "B": B, "L": L, "K": K,
               "E": E, "H": H, "d": d, "kernel": kernel, "calls": 1,
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "max_abs_err_chunked": (out_chunked.float() - ref.float())
               .abs().max().item(),
               "max_abs_err_k2": (out_k2.float() - ref_k2.float()).abs()
               .max().item()}
        del out, out_chunked, out_k2, ref, ref_k2
        qh, kh, vh = (t.contiguous() for t in heads)
        # SDPA takes no shared context: the codebook expanded to the batch
        ks, vs = (t.expand(B, -1, -1, -1).contiguous() for t in (kh, vh))
        mask = bias.to(dtype)[:, None, None, :]

        def new():
            return fa.fused_attention_packed(q, k, v, bias, num_heads=H)

        with torch.no_grad():
            row.update(attention_times(
                torch, new,
                lambda: fa.fused_attention_packed_reference(
                    q, k, v, bias, num_heads=H),
                lambda: F.scaled_dot_product_attention(qh, ks, vs,
                                                       attn_mask=mask)))
            turns = [device_ms(torch, f) for f in
                     (new, lambda: chunked(q, k, v, bias),
                      lambda: chunked(q, k, v, bias), new)]
            row["device_ms_k2"] = device_ms(
                torch, lambda: fa.fused_attention(qh, kh, vh, bias))
        row["device_ms_turns"] = turns
        row["device_ms"] = (turns[0] + turns[3]) / 2
        row["chunked_device_ms"] = (turns[1] + turns[2]) / 2
        row["chunked_over_kernel"] = row["chunked_device_ms"] / row[
            "device_ms"]
        row.update(attention_bound(q, k, v, bias, B * H * L * K, d, rate))
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        print(f"  timed width {name} {dtype_name} d {d}: {kernel} "
              f"{row['device_ms']:.4f} ms device (turns "
              + " / ".join(f"{t:.4f}" for t in turns)
              + f"), d-chunked {row['chunked_device_ms']:.4f} "
              f"({row['chunked_over_kernel']:.2f}x), SDPA "
              f"{row['library_device_ms']:.4f}, K2 {row['device_ms_k2']:.4f}"
              f", bound {row['bound_ms']:.4f} ({row['bound_kind']}, share "
              f"{row['bound_share']:.3f}); max_abs_err {row['max_abs_err']:.3e}"
              f" (d-chunked {row['max_abs_err_chunked']:.3e}, K2 "
              f"{row['max_abs_err_k2']:.3e}) on {card}", flush=True)
        del q, k, v, bias, heads, qh, kh, vh, ks, vs, mask
    return rows


def attention_widths(torch, configs, ReenactmentPipeline, seeded_nets, fa,
                     rate, seed, card):
    """Attention at the head widths of the flagship generator at n_head 1,
    2 and 32 (HEAD_COUNTS): K1 and K2 against their plain versions at
    every attention shape of a frame batch at each, in float32 and
    bfloat16 (timed against the bound and SDPA as the K1 and K2 phases
    time theirs), and at RAGGED_WIDTHS; one flagship frame batch at each
    n_head through ReenactmentPipeline.animate (ablation_inference), its
    32 K1 launches counted by kernel against what plan names, one at
    appearance d = 96 and one at d = 384 (the latter's captured inputs
    held against the plain version), and one in float32 at n_head 1 (the
    appearance transformer's 16 on the float32 wide kernel); the tiny
    variants with motion d = 1 and appearance d = 128, and at appearance
    d = 320 and 640, in float32 on the card against the CPU, within 1
    level, on the d = 1 and the float32 wide kernels."""
    t0 = time.perf_counter()
    sms = rate["sms"]
    report = {"k1": {}, "k2": {}, "frame_batches": {}, "halves": {}}
    for H in HEAD_COUNTS:
        cases = attention_cases(FRAME_BATCH, H=H)
        print(f"attention widths: n_head {H} (motion d = {32 // H}, "
              f"appearance d = {256 // H})", flush=True)
        k1 = check_attention(torch, fa, FRAME_BATCH, rate, cases=cases)
        k2 = check_attention_split(torch, fa, FRAME_BATCH, rate,
                                   cases=cases)
        got = Counter()
        for r in k1:
            if r["on_path"]:
                got[r["kernel"]] += r["launches_per_frame_batch"]
        assert got == head_width_kernels(torch, fa, H, sms), (H, got)
        report["k1"][H], report["k2"][H] = k1, k2
        report["halves"][H] = {"k1": width_halves(k1),
                               "k2": width_halves(
                                   k2, "k1_launches_per_frame_batch")}
        for layout, halves in report["halves"][H].items():
            for key, h in halves.items():
                print(f"attention widths: n_head {H} {layout} {key}: "
                      f"{h['launches']} launches, {h['device_ms']:.4f} ms "
                      f"device, SDPA {h['library_device_ms']:.4f}, bound "
                      f"{h['bound_ms']:.4f} (share {h['bound_share']:.3f}) "
                      f"on {card}", flush=True)
        torch.cuda.empty_cache()
    report["k1"]["ragged"] = check_attention(torch, fa, FRAME_BATCH, rate,
                                             cases=RAGGED_WIDTHS)
    report["k2"]["ragged"] = check_attention_split(
        torch, fa, FRAME_BATCH, rate, cases=RAGGED_WIDTHS)
    report["timed"] = timed_widths(torch, fa, rate, card)
    torch.cuda.empty_cache()
    for H in HEAD_COUNTS:
        row, _ = ablation_inference(torch, configs, ReenactmentPipeline,
                                    seeded_nets, fa, f"n_head_{H}", seed)
        row["k1_kernels"] = dict(fa.launch_kernels)
        want = head_width_kernels(torch, fa, H, sms)
        assert fa.launch_kernels == want, (H, fa.launch_kernels, want)
        if H == 1:  # the appearance half on the d = 256 wgmma kernel
            assert fa.launch_kernels["wgmma256"] == 16, fa.launch_kernels
            assert "chunked" not in fa.launch_kernels, fa.launch_kernels
        if H == 2:  # the appearance half on the d = 128 wgmma kernel
            assert fa.launch_kernels["wgmma128"] == 16, fa.launch_kernels
        report["frame_batches"][H] = row
        torch.cuda.empty_cache()
        print(f"attention widths: flagship-256 bf16 at n_head {H}: "
              f"{row['frames_per_s']:.2f} frames/s (one frame batch of "
              f"{FRAME_BATCH}), K1 {row['k1_launches']} launches by kernel "
              f"{row['k1_kernels']} on {card}", flush=True)
    # appearance d = 96 (n_head 2, E 192): the appearance half on the
    # d = 128 wgmma design at D = 96
    row, _ = ablation_inference(torch, configs, ReenactmentPipeline,
                                seeded_nets, fa, "app_d96", seed)
    row["k1_kernels"] = dict(fa.launch_kernels)
    want = head_width_kernels(torch, fa, 2, sms, E_app=192)
    assert fa.launch_kernels == want == {"f32": 16, "wgmma128": 16}, (
        fa.launch_kernels, want)
    report["frame_batch_app_d96"] = row
    torch.cuda.empty_cache()
    print(f"attention widths: flagship-256 bf16 at appearance d = 96: "
          f"{row['frames_per_s']:.2f} frames/s (one frame batch of "
          f"{FRAME_BATCH}), K1 {row['k1_launches']} launches by kernel "
          f"{row['k1_kernels']} on {card}", flush=True)
    # appearance d = 384 (n_head 1, E 384): the appearance half on the
    # d = 512 wgmma design at W = 192; K1 held against the plain version on
    # the frame batch's 32 captured inputs (its 12 unbiased appearance
    # calls among them)
    row, captured = ablation_inference(torch, configs, ReenactmentPipeline,
                                       seeded_nets, fa, "app_d384", seed,
                                       capture=True)
    row["k1_kernels"] = dict(fa.launch_kernels)
    want = head_width_kernels(torch, fa, 1, sms, E_app=384)
    assert fa.launch_kernels == want == {"f32": 16, "wgmma512": 16}, (
        fa.launch_kernels, want)
    row["captured"] = check_captured_attention(
        torch, fa, captured, "one flagship frame batch at appearance d = 384")
    del captured
    report["frame_batch_app_d384"] = row
    torch.cuda.empty_cache()
    print(f"attention widths: flagship-256 bf16 at appearance d = 384: "
          f"{row['frames_per_s']:.2f} frames/s (one frame batch of "
          f"{FRAME_BATCH}), K1 {row['k1_launches']} launches by kernel "
          f"{row['k1_kernels']} on {card}", flush=True)
    # a float32 generator at n_head 1: the appearance half at d = 256
    row, _ = ablation_inference(torch, configs, ReenactmentPipeline,
                                seeded_nets, fa, "n_head_1", seed,
                                dtype=torch.float32)
    row["k1_kernels"] = dict(fa.launch_kernels)
    assert fa.launch_kernels == {"f32": 16, "f32wide": 16}, row
    report["frame_batch_float32"] = row
    torch.cuda.empty_cache()
    print(f"attention widths: flagship-256 float32 at n_head 1: "
          f"{row['frames_per_s']:.2f} frames/s (one frame batch of "
          f"{FRAME_BATCH}), K1 {row['k1_launches']} launches by kernel "
          f"{row['k1_kernels']} on {card}", flush=True)
    diff, launches = tiny_frames(
        torch, ablation_cfg(configs.get("tiny"), "tiny_d1_d128"),
        ReenactmentPipeline, seeded_nets, fa, seed, 6)
    kernels = dict(fa.launch_kernels)
    assert set(kernels) == {"d1", "f32wide"}, kernels
    report["tiny_d1_d128"] = {"max_diff_levels": int(diff.max()),
                              "mean_diff_levels": float(diff.mean()),
                              "k1_launches": launches,
                              "k1_kernels": kernels}
    print(f"attention widths: tiny f32 (motion d = 1, appearance d = 128) "
          f"card vs CPU max |diff| {diff.max()} levels, K1 {kernels}",
          flush=True)
    diff, launches = tiny_frames(
        torch, ablation_cfg(configs.get("tiny"), "tiny_d320"),
        ReenactmentPipeline, seeded_nets, fa, seed, 6)
    kernels = dict(fa.launch_kernels)
    assert set(kernels) == {"f32", "f32wide"}, kernels
    report["tiny_d320"] = {"max_diff_levels": int(diff.max()),
                           "mean_diff_levels": float(diff.mean()),
                           "k1_launches": launches, "k1_kernels": kernels}
    print(f"attention widths: tiny f32 (appearance d = 320) card vs CPU max "
          f"|diff| {diff.max()} levels, K1 {kernels}", flush=True)
    diff, launches = tiny_frames(
        torch, ablation_cfg(configs.get("tiny"), "tiny_d640"),
        ReenactmentPipeline, seeded_nets, fa, seed, 6)
    kernels = dict(fa.launch_kernels)
    assert set(kernels) == {"f32", "f32wide"}, kernels
    report["tiny_d640"] = {"max_diff_levels": int(diff.max()),
                           "mean_diff_levels": float(diff.mean()),
                           "k1_launches": launches, "k1_kernels": kernels}
    report["seconds"] = time.perf_counter() - t0
    print(f"attention widths: tiny f32 (appearance d = 640) card vs CPU max "
          f"|diff| {diff.max()} levels, K1 {kernels}; phase "
          f"{report['seconds']:.1f} s on {card}", flush=True)
    return report


def attention_widths_process(rank, world, out_path, seed, card):
    """attention_widths in a process of its own (run_ranks, world 1), its
    report written to ``out_path`` as JSON. Run late in the one long
    process, the phase saw the card machine's profiler lose device
    activity at n_head 32 (SDPA's device time a fifth of its event time,
    then three sessions with none), after some 250 profiler sessions in
    the process and with the plain versions' ~10 GiB there in the
    allocator's cache; which of the two caused it is not known. A fresh
    process holds neither; and every profiler session is held against
    the CUDA-event window around it (activity_lost), so a partial loss
    in any phase reruns the session or fails."""
    import torch

    sys.path.insert(0, ROOT)
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.inference import (
        ReenactmentPipeline,
    )
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa
    from synergize_motion_appearance_tpu_torch.weights import seeded_nets

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        report = attention_widths(torch, configs, ReenactmentPipeline,
                                  seeded_nets, fa, exp_rate(torch), seed,
                                  card)
    except AssertionError as e:
        if str(e).startswith(PROFILER_LOST):
            with open(out_path + ".lost", "w") as f:
                f.write(str(e))
        raise
    with open(out_path, "w") as f:
        json.dump(report, f)


def attention_widths_phase(seed, card):
    """attention_widths_process's report, from a spawned process (its
    dict keys, n_head among them, as strings). A process whose profiler
    sessions all lost device activity at one call (device_times' error;
    on the card's machine a process now and then loses it for good after
    one to two hundred sessions) is run once more, whole, in a fresh
    process; any other failure, and a second loss, fails the phase."""
    work = os.path.join(ROOT, "build", "chip_smoke_widths")
    out_path = os.path.join(work, "report.json")
    for attempt in range(2):
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            run_ranks(attention_widths_process, 1, (out_path, seed, card),
                      WIDTHS_TIMEOUT)
            with open(out_path) as f:
                return json.load(f)
        except AssertionError:
            if attempt or not os.path.exists(out_path + ".lost"):
                raise
            with open(out_path + ".lost") as f:
                print(f"attention widths: {f.read()}; the phase runs once "
                      f"more in a fresh process", flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def write_frame_cache(torch, native_loader, path, seed):
    """A native frame cache of CACHE_VIDEOS videos of CACHE_FRAMES seeded
    image-like CACHE_SIZE^2 RGB frames (smooth_train_batch's recipe: a random
    8x8 field, bilinearly upsampled, plus a little noise), written with the
    port's write_cache."""
    rng = np.random.RandomState(seed)
    n = CACHE_VIDEOS * CACHE_FRAMES
    low = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 8, 8))
                           .astype(np.float32))
    img = torch.nn.functional.interpolate(
        low, size=(CACHE_SIZE, CACHE_SIZE), mode="bilinear")
    img = (img + 0.05 * torch.from_numpy(rng.randn(*img.shape)
                                         .astype(np.float32))).clamp(-1, 1)
    u8 = ((img + 1) * 127.5).round().to(torch.uint8).permute(0, 2, 3, 1)
    u8 = u8.contiguous().numpy()
    native_loader.write_cache(
        path, ((CACHE_FRAMES, iter(u8[i * CACHE_FRAMES:
                                      (i + 1) * CACHE_FRAMES]))
               for i in range(CACHE_VIDEOS)), CACHE_SIZE, CACHE_SIZE, 3)


def checkpoint_equals(torch, ckpt, tr):
    """Whether a trainer holds exactly the state of a loaded checkpoint:
    every tensor bit for bit, the step and the Adam counts."""
    st = tr.state
    pairs = [(ckpt["ema_g"], st.ema_g)]
    pairs += [(ckpt[n], getattr(tr, n).state_dict())
              for n in ("net_g", "motion_estimator", "net_d", "vgg")]
    for n in ("opt_g", "opt_m", "opt_d"):
        o = getattr(st, n)
        if ckpt[n]["count"] != o.count:
            return False
        pairs += [(ckpt[n]["mu"], o.mu), (ckpt[n]["nu"], o.nu)]
    return ckpt["step"] == st.step and all(
        sorted(a) == sorted(b) and all(torch.equal(a[k], b[k].cpu())
                                       for k in a) for a, b in pairs)


def train_cli(torch, configs, fa, k3, seed, card):
    """train.run at FLAGSHIP_TRAIN (256^2, batch 2, bf16,
    net_d_start_iter 1) over a native frame cache: CLI_STEPS steps with
    print_freq 1 and checkpoints every 2 steps; the step-2 checkpoint
    restored into a fresh Trainer (other seed) must equal the saved state
    bit for bit; a second run resumes from it and reaches step CLI_STEPS.
    Kernel counts are set to 0 just before each run and read just after.
    Everything it writes, under build/chip_smoke, is removed afterwards."""
    from synergize_motion_appearance_tpu_torch import train
    from synergize_motion_appearance_tpu_torch.data import native_loader
    from synergize_motion_appearance_tpu_torch.training import (
        Trainer, restore_checkpoint, save_checkpoint,
    )
    from synergize_motion_appearance_tpu_torch.utils.options import (
        derive_paths,
    )

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cache = os.path.join(work, "frames.fc")
    t0 = time.perf_counter()
    write_frame_cache(torch, native_loader, cache, seed + 50)
    cache_s = time.perf_counter() - t0

    def options(resume=None):
        opt = configs.get("flagship_train")
        opt.update(name="chip-smoke-train", manual_seed=seed)
        opt["train"].update(net_d_start_iter=1, total_iter=CLI_STEPS)
        opt["datasets"]["train"].update(
            name="seeded image-like frames", native_cache=cache,
            num_worker_per_gpu=4, dataset_enlarge_ratio=1)
        opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2,
                         "use_tb_logger": False}
        opt["path"] = {"save_path": work, "resume_state": resume}
        return derive_paths(opt)

    g_cfg = configs.get("flagship_train")["network_g"]
    per_step = {"k1": k1_per_train_step(g_cfg),
                "k3": 2 * sum(k3_forward_convs(g_cfg).values())}
    report = {"config": "flagship_train (options/train.yml), "
                        "net_d_start_iter 1, native frame cache",
              "cache_bytes": os.path.getsize(cache), "cache_write_s": cache_s,
              "cache_videos": CACHE_VIDEOS, "cache_frames": CACHE_FRAMES}
    ckpt2 = None
    for run_name, first_iter in (("fresh", 1), ("resumed", 3)):
        opt = options(ckpt2)
        fa.reset_launches()
        k3.reset_launches()
        t0 = time.perf_counter()
        records = train.run(opt, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": fa.launches, "k2": fa.split_launches,
                    "k3": k3.launches, "k4": k3.nhwc_launches}
        steps = CLI_STEPS - first_iter + 1
        assert [r["iter"] for r in records] == list(
            range(first_iter, CLI_STEPS + 1)), [r["iter"] for r in records]
        for r in records:
            for k, v in r.items():
                if isinstance(v, float):
                    assert math.isfinite(v), (run_name, r["iter"], k, v)
            assert r["step_skipped_nonfinite"] == 0.0, (run_name, r["iter"])
            assert (r["d_weight"] > 0) == (r["iter"] >= 3), r
        assert launches["k1"] == steps * per_step["k1"], launches
        assert launches["k3"] == steps * per_step["k3"], launches
        assert launches["k2"] == launches["k4"] == 0, launches
        states = opt["path"]["training_states"]
        assert os.path.exists(os.path.join(states, f"iter_{CLI_STEPS}"))
        report[run_name] = {
            "wall_s": wall, "launches": launches,
            "step_ms": [1e3 * r["time"] for r in records],
            "data_ms": [1e3 * r["data_time"] for r in records],
            "logs": [{k: v for k, v in r.items() if k not in ("time",
                                                              "data_time")}
                     for r in records]}
        if run_name == "fresh":
            ckpt2 = os.path.join(states, "iter_2")
            report["checkpoint_bytes"] = os.path.getsize(ckpt2)
            t0 = time.perf_counter()
            saved = torch.load(ckpt2, map_location="cpu", weights_only=True)
            read_s = time.perf_counter() - t0
            fresh = Trainer(options(), device="cuda", seed=seed + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_checkpoint(ckpt2, fresh)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            assert checkpoint_equals(torch, saved, fresh), (
                "the restored step-2 state differs from the saved one")
            t0 = time.perf_counter()
            path = save_checkpoint(os.path.join(work, "save_timing"), fresh,
                                   saved["epoch"])
            save_s = time.perf_counter() - t0
            assert os.path.getsize(path) > 0
            report.update(checkpoint_read_s=read_s, checkpoint_load_s=load_s,
                          checkpoint_save_s=save_s, restored_bit_exact=True)
            del saved, fresh
            shutil.rmtree(os.path.join(work, "save_timing"))
            torch.cuda.empty_cache()
    shutil.rmtree(work)

    fresh = report["fresh"]
    # a step's time runs from the end of the previous step's logging, so,
    # as in the JAX entry point, it holds any checkpoint saved in between;
    # step 1 holds first-call set-up: the steady steps are the others
    steady = [i for i in range(1, CLI_STEPS) if i % 2 == 1]
    report["steady_steps"] = [i + 1 for i in steady]
    report["step_ms_median"] = float(np.median(
        [fresh["step_ms"][i] for i in steady]))
    report["data_ms_median"] = float(np.median(
        [fresh["data_ms"][i] for i in steady]))
    report["data_share"] = sum(fresh["data_ms"][i] for i in steady) / sum(
        fresh["step_ms"][i] for i in steady)
    print(f"train CLI flagship_train (net_d_start_iter 1) bf16 batch "
          f"{TRAIN_BATCH} on {card}, native cache of {CACHE_VIDEOS}x"
          f"{CACHE_FRAMES} frames ({report['cache_bytes']} bytes): "
          f"{CLI_STEPS} steps, ms/step "
          f"{[round(x, 2) for x in fresh['step_ms']]}"
          f" (step 1 with set-up, step 3 with the step-2 checkpoint's save; "
          f"median of steps {report['steady_steps']} "
          f"{report['step_ms_median']:.2f}), data_time ms "
          f"{[round(x, 3) for x in fresh['data_ms']]} (share of those steps "
          f"{report['data_share']:.5f}); checkpoint "
          f"{report['checkpoint_bytes']} bytes, save "
          f"{report['checkpoint_save_s']:.2f} s, load into a Trainer "
          f"{report['checkpoint_load_s']:.2f} s (file read "
          f"{report['checkpoint_read_s']:.2f} s), restored bit for bit; "
          f"resumed from step 2 to {CLI_STEPS}: ms/step "
          f"{[round(x, 2) for x in report['resumed']['step_ms']]}; K1 "
          f"{per_step['k1']} and K3 {per_step['k3']} launches per step, "
          f"K2 and K4 none", flush=True)
    return report


# ---------------------------------------------------------------------------
# distributed: the data-parallel train step, remat, frame parallelism
# ---------------------------------------------------------------------------

DP_STEPS = 2        # steps of each data-parallel run
DP_TINY_STEPS = 5   # steps of the tiny split-batch parity (from the third, D)
DP_GLOBAL_TINY = 4  # the tiny parity's global batch, split 2 + 2
# The tiny split step against the whole-batch step: a float32 step of
# these networks has kinks (ReLU and LeakyReLU after BatchNorm, the hinge,
# L1), and the split's other summation order can put an activation on
# the other side of one: the logs agree, the gradient upstream of it
# jumps. chip_dp_spread.py found such steps off compare_updates' bounds
# on an H100 in 2 of 30 and 7 of 48 steps (M up to 0.155, D up to 6.1e-3
# in 2-norm; shares down to 0.397), on the CPU, where both runs are
# fixed, in 4 of 48 (M up to 1.33e-2, G 6.33e-3), while the one-process
# step repeated stays 1e-6 from itself. A fault of the split step misses
# at every step, a kink at one: each network and group holds the bounds
# at one step at least (bounds_missed), and every step holds a gradient
# 2-norm gap below DP_GROSS_GAP, which a sum for a mean or a lost half
# of the batch exceeds.
DP_GROSS_GAP = 0.5
REMAT_BATCH = 8     # options/train_v5e2.yml's batch per card
RANK_TIMEOUT = 420  # seconds for a spawned rank


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def state_digest(torch, tr):
    """sha256 of every tensor of a trainer's state (weights, statistics,
    EMA, Adam moments), in a fixed order: equal digests are equal bits."""
    import hashlib

    st = tr.state
    h = hashlib.sha256()
    groups = [tr.net_g.state_dict(), tr.motion_estimator.state_dict(),
              tr.net_d.state_dict(), st.ema_g]
    for o in (st.opt_g, st.opt_m, st.opt_d):
        groups += [o.mu, o.nu]
    for g in groups:
        for k in sorted(g):
            h.update(k.encode())
            h.update(g[k].detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def lr_of(tr, step):
    return max(f(step) for f in (tr.lr_g, tr.lr_m, tr.lr_d))


def state_gap(torch, a, b):
    """How far two runs' states (train_state-like dicts) lie apart: the
    largest difference of the weights, statistics and EMA, and the share
    of their entries within 1e-6."""
    diffs = []
    for group in ("g", "m", "d", "ema"):
        keys = sorted(a[group])
        assert keys == sorted(b[group]), group
        diffs += [(a[group][k] - b[group][k]).abs().flatten() for k in keys]
    diffs = torch.cat(diffs)
    for net in ("g", "m", "d"):
        assert a[net + "_count"] == b[net + "_count"], net
    return float(diffs.max()), float((diffs <= 1e-6).float().mean())


def dp_rank(rank, world, port, backend, work, seed):
    """One rank of the two-rank phase (spawned): (a) the tiny f32 step on
    its half of a global batch of DP_GLOBAL_TINY, from each of the
    one-process run's saved states; (b) DP_STEPS flagship bf16 steps on
    its half of a global batch of TRAIN_BATCH, with the kernel counts, the
    step's time and the state's digest after each step, then the time of
    the gradients' all-reduce alone. Writes <work>/rank<r>.pt."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa
    from synergize_motion_appearance_tpu_torch.parallel import (
        all_reduce_mean, init_distributed, mesh, shard_batch,
    )
    from synergize_motion_appearance_tpu_torch.training import (
        Trainer, restore_checkpoint, step_generator,
    )

    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(device)
    init_distributed("pytorch", backend=backend, device=device,
                     environ=rank_env(rank, world, port))
    out = {"device": device, "tiny": [], "flagship": []}
    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 1
    tr = Trainer(cfg, device=device, seed=seed + 1)  # other weights
    batch = shard_batch({k: v.to(device) for k, v in smooth_train_batch(
        torch, 64, seed + 60, n=DP_GLOBAL_TINY).items()})
    for i in range(DP_TINY_STEPS):
        restore_checkpoint(os.path.join(work, "states", f"iter_{i}"), tr)
        tr.broadcast_state()
        logs = tr.train_step(batch, generator=step_generator(seed, i,
                                                             device))
        out["tiny"].append({"logs": {k: float(v) for k, v in logs.items()},
                            "state": train_state(tr)})
    del tr

    cfg = configs.get("flagship_train")
    cfg["train"]["net_d_start_iter"] = 0  # D and the probe from step 2
    tr = Trainer(cfg, device=device, seed=seed)
    batch = shard_batch(train_batch(torch, 256, seed + 40, device))
    for i in range(DP_STEPS):
        fa.reset_launches()
        k3.reset_launches()
        mesh.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = tr.train_step(batch, generator=step_generator(seed, i,
                                                             device))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        out["flagship"].append({
            "ms": ms, "k1_launches": fa.launches, "k3_launches": k3.launches,
            "collectives": mesh.collectives,
            "collective_bytes": mesh.collective_bytes,
            "logs": {k: float(v) for k, v in logs.items()},
            "digest": state_digest(torch, tr)})
    grads = [{k: torch.randn_like(p) for k, p in named} for named in (
        list(tr.net_g.named_parameters())
        + list(tr.motion_estimator.named_parameters()),
        list(tr.net_d.named_parameters()))]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            all_reduce_mean(g)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["all_reduce_ms"] = times
    out["all_reduce_bytes"] = sum(v.numel() * 4 for g in grads
                                  for v in g.values())
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def run_ranks(fn, world, args, timeout):
    """fn(rank, world, *args) in `world` spawned processes; raises if one
    fails or is still running after `timeout` s (then it is killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(deadline - time.time(), 0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert not any(codes), f"ranks exited with {codes}"


def dp_world1(torch, configs, fa, k3, seed, card):
    """train.run at FLAGSHIP_TRAIN (net_d_start_iter 0) over a native frame
    cache (one loader thread, so the batches are fixed by the seed) for
    DP_STEPS steps through --launcher pytorch with RANK=0, WORLD_SIZE=1
    over NCCL, then twice through --launcher none: the gradient all-reduce
    runs in the first. Its step-DP_STEPS checkpoint lies no further from
    the plain run's than the plain run lies from itself: largest
    difference at most 3 times, share of entries within 1e-6 at most 0.05
    lower."""
    from synergize_motion_appearance_tpu_torch import train, training
    from synergize_motion_appearance_tpu_torch.data import native_loader
    from synergize_motion_appearance_tpu_torch.parallel import mesh
    from synergize_motion_appearance_tpu_torch.utils.options import (
        derive_paths,
    )

    work = os.path.join(ROOT, "build", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cache = os.path.join(work, "frames.fc")
    write_frame_cache(torch, native_loader, cache, seed + 50)
    per_step = []

    class Counting(training.Trainer):
        def train_step(self, *args, **kwargs):
            mesh.reset_collectives()
            logs = super().train_step(*args, **kwargs)
            per_step.append((mesh.collectives, mesh.collective_bytes))
            return logs

    def options(name):
        opt = configs.get("flagship_train")
        opt.update(name=name, manual_seed=seed)
        opt["train"].update(net_d_start_iter=0, total_iter=DP_STEPS)
        opt["datasets"]["train"].update(
            name="seeded image-like frames", native_cache=cache,
            num_worker_per_gpu=1, dataset_enlarge_ratio=1)
        opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": DP_STEPS,
                         "use_tb_logger": False}
        opt["path"] = {"save_path": work}
        return derive_paths(opt)

    report, states = {}, {}
    real_trainer = training.Trainer
    saved_env = {k: os.environ.get(k) for k in rank_env(0, 1, 0)}
    training.Trainer = Counting
    try:
        for name, launcher in (("pytorch", "pytorch"), ("none", "none"),
                               ("none_again", "none")):
            per_step.clear()
            os.environ.update(rank_env(0, 1, free_port()))
            opt = options(f"dp-{name}")
            fa.reset_launches()
            k3.reset_launches()
            t0 = time.perf_counter()
            records = train.run(opt, device="cuda", launcher=launcher)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for r in records:
                for k, v in r.items():
                    if isinstance(v, float):
                        assert math.isfinite(v), (name, r["iter"], k, v)
            path = os.path.join(opt["path"]["training_states"],
                                f"iter_{DP_STEPS}")
            states[name] = torch.load(path, map_location="cpu",
                                      weights_only=True)
            report[name] = {
                "wall_s": wall, "k1_launches": fa.launches,
                "k3_launches": k3.launches, "collectives": list(per_step),
                "step_ms": [1e3 * r["time"] for r in records],
                "logs": [{k: v for k, v in r.items()
                          if k not in ("time", "data_time")}
                         for r in records]}
    finally:
        training.Trainer = real_trainer
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(work)
    g_cfg = configs.get("flagship_train")["network_g"]
    k1_per, k3_per = (k1_per_train_step(g_cfg),
                      2 * sum(k3_forward_convs(g_cfg).values()))
    for name in ("pytorch", "none", "none_again"):
        assert report[name]["k1_launches"] == DP_STEPS * k1_per, report
        assert report[name]["k3_launches"] == DP_STEPS * k3_per, report
    colls = report["pytorch"]["collectives"]
    assert all(n > 0 for n, _ in colls), "no gradient all-reduce ran"
    assert all(n == 0 for n, _ in report["none"]["collectives"])
    # the first step's logs come before any update: the same batch and
    # weights give the same values
    assert report["pytorch"]["logs"][0] == report["none"]["logs"][0], (
        "world 1 and --launcher none started from other batches or weights")

    def flat(ckpt):
        out = {"g": ckpt["net_g"], "m": ckpt["motion_estimator"],
               "d": ckpt["net_d"], "ema": ckpt["ema_g"]}
        for n in ("g", "m", "d"):
            out[n + "_count"] = ckpt["opt_" + n]["count"]
        return {k: ({n: t.float() for n, t in v.items()}
                    if isinstance(v, dict) else v) for k, v in out.items()}

    # The bf16 step is not deterministic on the card (grid_sampler_2d's
    # backward adds with atomics; Adam's first steps turn a gradient's
    # rounding residue into a step of lr either way), so world 1 is held
    # against --launcher none by how far --launcher none lies from itself.
    worst, close = state_gap(torch, flat(states["pytorch"]),
                             flat(states["none"]))
    noise_worst, noise_close = state_gap(torch, flat(states["none_again"]),
                                         flat(states["none"]))
    report.update(bit_identical=(worst == 0.0), worst_abs_diff=worst,
                  share_within_1e6=close, repeat_worst_abs_diff=noise_worst,
                  repeat_share_within_1e6=noise_close,
                  collectives_per_step=[n for n, _ in colls],
                  collective_bytes_per_step=[b for _, b in colls],
                  k1_per_step=k1_per, k3_per_step=k3_per)
    print(f"distributed: train.run --launcher pytorch, world size 1 over "
          f"NCCL, flagship_train bf16 batch {TRAIN_BATCH} on {card}: "
          f"{DP_STEPS} steps, ms/step "
          f"{[round(x, 2) for x in report['pytorch']['step_ms']]} (plain "
          f"--launcher none {[round(x, 2) for x in report['none']['step_ms']]}"
          f"); collectives per step {report['collectives_per_step']} "
          f"carrying {report['collective_bytes_per_step']} bytes; K1 "
          f"{k1_per} and K3 {k3_per} launches per step; first step's logs "
          f"identical; weights after {DP_STEPS} steps against --launcher "
          f"none: largest difference {worst:.3e}, share within 1e-6 "
          f"{close:.6f} (--launcher none against itself: {noise_worst:.3e}, "
          f"{noise_close:.6f})", flush=True)
    assert worst <= 3 * noise_worst and close >= noise_close - 0.05, (
        "world 1 lies further from --launcher none than it from itself")
    return report


def dp_two_ranks(torch, configs, Trainer, fa, k3, seed, card):
    """Two ranks, spawned: over NCCL on cuda:0 and cuda:1 when there are two
    cards, else both on cuda:0 over gloo (NCCL refuses two ranks on one
    device). (a) against one process on the whole batch on the card, each
    of DP_TINY_STEPS steps from its state: the logs within 1e-4 relative
    + 1e-6, the weights, statistics and EMA after the update within 2 lr,
    and each network's gradient and second-moment increment within
    assert_grad_norms' bounds and the updates within 1e-6 on 0.999 of
    their entries (bounds_missed) at one step at least, and within
    DP_GROSS_GAP at every step; the worst leaf's gradient gap is printed,
    not held: on the card it moves from run to run, and once passed
    compare_updates' per-leaf bound (1.8 times, on G's first conv) with
    the network's norm and the update within their bounds; (b) the
    ranks' states bit-identical after each tiny step and after each
    flagship step, K1 and K3 per step on each rank."""
    from synergize_motion_appearance_tpu_torch.training import (
        save_checkpoint, step_generator,
    )

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    where = ("NCCL on cuda:0 and cuda:1" if backend == "nccl"
             else "gloo, both ranks on cuda:0 (one card)")
    work = os.path.join(ROOT, "build", "chip_smoke_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 1
    ref = Trainer(cfg, device="cuda", seed=seed)
    batch = {k: v.cuda() for k, v in smooth_train_batch(
        torch, 64, seed + 60, n=DP_GLOBAL_TINY).items()}
    before, after, logs, lrs = [], [], [], []
    for i in range(DP_TINY_STEPS):
        save_checkpoint(os.path.join(work, "states"), ref)
        before.append(train_state(ref))
        lrs.append(lr_of(ref, i))
        logs.append({k: float(v) for k, v in ref.train_step(
            batch, generator=step_generator(seed, i, "cuda")).items()})
        after.append(train_state(ref))
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(dp_rank, 2, (free_port(), backend, work, seed), RANK_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    shutil.rmtree(work)
    betas = [float(b) for b in cfg["train"]["optim_g"]["betas"]]
    worst_log, gaps, shares, off_bounds, held = 0.0, [], [], [], {}
    for i in range(DP_TINY_STEPS):
        got = ranks[0]["tiny"][i]
        grads, step_gaps = gradient_gaps(before[i], after[i], got["state"],
                                         betas)
        gaps.append(step_gaps)
        print(f"  two ranks, tiny step {i + 1}: gradients against one "
              f"process, by network: {step_gaps}", flush=True)
        for k, v in logs[i].items():
            err = abs(got["logs"][k] - v)
            worst_log = max(worst_log, err / (abs(v) + 1e-6))
            assert err <= 1e-4 * abs(v) + 1e-6, (i, k, got["logs"][k], v)
        assert (got["logs"]["d_weight"] > 0) == (i >= 2), got["logs"]
        for net in ("g", "m", "d"):
            assert got["state"][net + "_count"] == after[i][net + "_count"]
        shares.append({})
        assert_updates_close(torch, after[i], got["state"], grads, lrs[i],
                             min_share=None, shares=shares[-1])
        print(f"  two ranks, tiny step {i + 1}: share of updated entries "
              f"within 1e-6, by group: {shares[-1]}", flush=True)
        for net, gap in step_gaps.items():
            assert (gap["rel_norm"] <= DP_GROSS_GAP and gap["nu_rel_norm"]
                    <= 2 * DP_GROSS_GAP), (i, net, gap)
        missed = bounds_missed(step_gaps, shares[-1])
        for key in set(step_gaps) | set(shares[-1]):
            held.setdefault(key, []).append(key not in missed)
        if missed:
            off_bounds.append({"step": i + 1, "missed": missed})
            print(f"  two ranks, tiny step {i + 1} misses the bounds: "
                  f"{missed}", flush=True)
        for group, tensors in got["state"].items():
            other = ranks[1]["tiny"][i]["state"][group]
            if isinstance(tensors, dict):
                assert all(torch.equal(v, other[k])
                           for k, v in tensors.items()), (i, group)
    assert all(any(steps) for steps in held.values()), (held, off_bounds)
    g_cfg = configs.get("flagship_train")["network_g"]
    k1_per, k3_per = (k1_per_train_step(g_cfg),
                      2 * sum(k3_forward_convs(g_cfg).values()))
    for i in range(DP_STEPS):
        a, b = (r["flagship"][i] for r in ranks)
        assert a["digest"] == b["digest"], f"ranks part at step {i + 1}"
        assert a["logs"] == b["logs"], i
        for r in (a, b):
            assert r["k1_launches"] == k1_per, r
            assert r["k3_launches"] == k3_per, r
            for k, v in r["logs"].items():
                assert math.isfinite(v), (i, k, v)
            assert r["logs"]["step_skipped_nonfinite"] == 0.0
        assert (a["logs"]["d_weight"] > 0) == (i >= 1), a["logs"]
    report = {
        "backend": backend, "where": where, "spawn_and_run_s": ranks_s,
        "tiny_worst_log_rel_diff": worst_log, "tiny_gradient_gaps": gaps,
        "tiny_updated_share_within_1e6": shares,
        "tiny_steps_off_bounds": off_bounds,
        "k1_launches": ranks[0]["flagship"][-1]["k1_launches"],
        "k3_launches": ranks[0]["flagship"][-1]["k3_launches"],
        "ranks": [{"device": r["device"],
                   "step_ms": [s["ms"] for s in r["flagship"]],
                   "collectives": [s["collectives"] for s in r["flagship"]],
                   "collective_bytes": [s["collective_bytes"]
                                        for s in r["flagship"]],
                   "digests": [s["digest"] for s in r["flagship"]],
                   "all_reduce_ms": r["all_reduce_ms"],
                   "all_reduce_bytes": r["all_reduce_bytes"]}
                  for r in ranks]}
    ranks = report["ranks"]
    label = "gloo, one card" if backend == "gloo" else "NCCL, two cards"
    print(f"distributed: two ranks, {where}: (a) tiny f32, global batch "
          f"{DP_GLOBAL_TINY} split 2 + 2, {DP_TINY_STEPS} steps against one "
          f"process on the whole batch on the card, each from its state: "
          f"logs worst {worst_log:.3e} relative, gradients and second "
          f"moments' increments worst relative 2-norm "
          f"{max(g['rel_norm'] for st in gaps for g in st.values()):.3e} "
          f"and "
          f"{max(g['nu_rel_norm'] for st in gaps for g in st.values()):.3e}"
          f", updates within 1e-6 on a share of at least "
          f"{min(min(st.values()) for st in shares):.5f} of the entries "
          f"({len(off_bounds)} of {DP_TINY_STEPS} steps off the bounds, "
          f"each network within them at one step at least), every entry "
          f"within 2 lr, "
          f"ranks bit-identical; (b) flagship_train "
          f"bf16, global batch {TRAIN_BATCH} split 1 + 1, {DP_STEPS} steps "
          f"on {card}: ranks bit-identical after every step (sha256 of the "
          f"state), K1 {report['k1_launches']} and K3 "
          f"{report['k3_launches']} launches per step on each rank; "
          f"ms/step ({label}) "
          f"{[[round(x, 2) for x in r['step_ms']] for r in report['ranks']]}"
          f"; all-reduce of the G+M and D gradients alone "
          f"({report['ranks'][0]['all_reduce_bytes']} bytes, {label}) "
          f"{[round(float(np.median(r['all_reduce_ms'])), 2) for r in ranks]}"
          f" ms", flush=True)
    return report


def grad_rel_gap(torch, a, b, b1, beyond_ulp):
    """How far the gradients behind Adam first moments ``a`` lie from those
    behind ``b`` (one step from zero moments: gradient = mu / (1 - b1)),
    leaf by leaf: the 2-norm of the differences over the 2-norm of b's
    gradients. With ``beyond_ulp`` each element's difference is first
    cut by one bf16 ulp of the larger of its two magnitudes (2^(e - 8)
    for a magnitude in [2^(e-1), 2^e)), so that a bf16 value rounded to
    its other neighbour counts 0."""
    num = den = 0.0
    for k in b:
        ga, gb = a[k] / (1 - b1), b[k] / (1 - b1)
        diff = (ga - gb).abs()
        if beyond_ulp:
            _, e = torch.frexp(torch.maximum(ga.abs(), gb.abs()))
            diff = (diff - torch.ldexp(torch.ones_like(diff), e - 8)
                    ).clamp(min=0)
        num += float((diff ** 2).sum())
        den += float((gb ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def remat_modes(torch, configs, Trainer, k3, seed, card):
    """options/train_v5e2.yml's recipe on one card: FLAGSHIP_TRAIN's
    networks, batch REMAT_BATCH, bf16, with remat false, true and
    selective: one step each from the same seeded state, then one more,
    timed; peak memory of each step (max_memory_allocated, and above what
    was allocated before it) and K3's forward and input-gradient
    launches. Remat changes no op, so the first step's logs are the same
    in every mode, bit for bit (the forward is deterministic), and its
    gradients (from the Adam first moments) are held across the modes
    against how far a second run of remat false lies from the first (the
    bf16 step is not deterministic on the card): a mode may lie at most 3
    times that (plus 1e-4) from false, relative 2-norm per network of
    what each element differs by beyond one bf16 ulp of its magnitude. A
    bf16 weight gradient whose sum lands near a rounding boundary rounds
    to either neighbour from run to run: two entries of G's
    motion_emb.1.conv (two thirds of G's squared gradient norm) move G's
    whole relative gap between 2.4e-5 and 1.8e-4 from run to run, remat
    or not; beyond one ulp it stays near 1.0e-5 (grad_rel_gap). The whole
    gap and the leaf that holds most of it are printed, not held."""
    batch = train_batch(torch, 256, seed + 70, "cuda", n=REMAT_BATCH)
    report, mus, logs0 = {}, {}, {}
    for mode in (False, True, "selective", "false again"):
        cfg = configs.get("flagship_train")
        cfg["train"]["remat"] = False if mode == "false again" else mode
        cfg["datasets"]["train"]["batch_size_per_gpu"] = REMAT_BATCH
        tr = Trainer(cfg, device="cuda", seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 71)
        row = {"steps": []}
        for i in range(1 if mode == "false again" else 2):
            k3.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            logs = tr.train_step(batch, generator=gen)
            torch.cuda.synchronize()
            row["steps"].append({
                "ms": 1e3 * (time.perf_counter() - t0),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "peak_above_base_bytes":
                    torch.cuda.max_memory_allocated() - base,
                "k3_forward": k3.launches - k3.input_grad_launches,
                "k3_input_grad": k3.input_grad_launches})
            for k, v in logs.items():
                assert math.isfinite(float(v)), (mode, i, k)
            if i == 0:
                logs0[mode] = {k: float(v) for k, v in logs.items()}
                st = tr.state
                mus[mode] = {n: {k: v.float().cpu() for k, v in
                                 getattr(st, "opt_" + n).mu.items()}
                             for n in ("g", "m")}
        report[str(mode)] = row
        del tr
        torch.cuda.empty_cache()
    b1 = float(cfg["train"]["optim_g"]["betas"][0])
    worst, raw, leaf = {}, {}, {}
    for n in ("g", "m"):
        for mode in ("false again", True, "selective"):
            a, b = mus[mode][n], mus[False][n]
            worst[f"{mode}/{n}"] = grad_rel_gap(torch, a, b, b1, True)
            raw[f"{mode}/{n}"] = grad_rel_gap(torch, a, b, b1, False)
            sq = {k: float(((a[k] - b[k]) ** 2).sum()) for k in b}
            top = max(sq, key=sq.get)
            leaf[f"{mode}/{n}"] = [top, sq[top] / max(sum(sq.values()),
                                                      1e-30),
                                   int((a[top] != b[top]).sum())]
    f, t, s = (report[m]["steps"] for m in ("False", "True", "selective"))
    report.update(batch=REMAT_BATCH, grad_rel_norm_diff=worst,
                  grad_rel_norm_diff_raw=raw, grad_gap_top_leaf=leaf,
                  first_logs_identical=all(
                      logs0[m] == logs0[False] for m in logs0),
                  config="flagship_train networks, options/train_v5e2.yml "
                         "batch 8, bf16, D off (net_d_start_iter 5001)")
    print(f"distributed: remat at train_v5e2.yml's recipe (flagship, batch "
          f"{REMAT_BATCH}, bf16) on {card}, second step of each mode: "
          + "; ".join(
              f"{m}: {report[m]['steps'][1]['ms']:.2f} ms/step, peak "
              f"{st['peak_bytes'] / 2 ** 30:.2f} GiB "
              f"({st['peak_above_base_bytes'] / 2 ** 30:.2f} above the "
              f"resident state), K3 forward {st['k3_forward']} + input "
              f"gradient {st['k3_input_grad']} launches"
              for m, st in (("False", f[1]), ("True", t[1]),
                            ("selective", s[1])))
          + f"; first step's logs identical across modes: "
          f"{report['first_logs_identical']}; gradients against remat "
          f"false, relative 2-norm beyond one bf16 ulp an element: "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (all of "
          f"it: { {k: float(f'{v:.3e}') for k, v in raw.items()} }; the "
          f"leaf with most of it, its share of the squared gap and its "
          f"entries that differ: {leaf})", flush=True)
    fwd = f[1]["k3_forward"]
    assert f[1]["k3_input_grad"] == fwd > 0, f
    assert t[1]["k3_forward"] == 2 * fwd, t
    assert s[1]["k3_forward"] == fwd, s
    assert s[1]["k3_input_grad"] == t[1]["k3_input_grad"] == fwd
    assert s[1]["peak_bytes"] < f[1]["peak_bytes"], (s, f)
    assert report["first_logs_identical"], logs0
    for n in ("g", "m"):
        noise = worst[f"false again/{n}"]
        for mode in (True, "selective"):
            assert worst[f"{mode}/{n}"] <= 3 * noise + 1e-4, (mode, n, worst)
    return report


def frame_parallel(torch, configs, ReenactmentPipeline, seeded_nets, fa,
                   seed, card):
    """The main path's pipeline (flagship, uint8, FRAMES frames, frame batch
    FRAME_BATCH) with a mesh over every visible card, or [cuda:0, cuda:0]
    on one card so that the split and the gather run, against mesh=None.
    The split halves the generator's batch per call, and in bf16 the
    pipeline's frames depend on that batch through cuDNN's choice of
    algorithm (random weights amplify bf16 rounding), as the one-device
    pipeline's own frames do when its frame batch changes. So: in float32
    the mesh's frames are within 1 level of mesh=None's; in bf16 (timed,
    frames/s and K1 per frame batch) they lie no further from mesh=None's
    than the one-device pipeline at frame batch FRAME_BATCH / 2 lies from
    it at FRAME_BATCH (max, and 1.5 x the mean + 0.05)."""
    from synergize_motion_appearance_tpu_torch.parallel import create_mesh

    devices = create_mesh()
    if len(devices) == 1:
        devices = devices * 2
    cfg = configs.get("flagship_256")
    src = frames(1, 256, seed + 20)
    drv = frames(FRAMES, 256, seed + 21)
    n_batches = math.ceil(FRAMES / FRAME_BATCH)
    report = {"mesh_devices": [str(d) for d in devices]}
    outs = {}
    runs = (("one", None, torch.bfloat16, FRAME_BATCH),
            ("mesh", devices, torch.bfloat16, FRAME_BATCH),
            ("one_half_batch", None, torch.bfloat16, FRAME_BATCH // 2),
            ("one_f32", None, torch.float32, FRAME_BATCH),
            ("mesh_f32", devices, torch.float32, FRAME_BATCH))
    for name, m, dtype, fb in runs:
        g, me = seeded_nets(cfg, seed)
        kw = dict(pipeline_kw(torch), compute_dtype=dtype, frame_batch=fb)
        pipe = ReenactmentPipeline(g, me, mesh=m, **kw)
        pipe.animate(src, drv[:fb])  # first-call set-up
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = pipe.animate(src, drv).astype(np.int32)
        s = time.perf_counter() - t0
        report[name] = {"frames_per_s": FRAMES / s, "frame_batch": fb,
                        "k1_per_frame_batch": fa.launches * fb / FRAMES}
        del pipe, g, me
        torch.cuda.empty_cache()
    def gap(a, b):
        d = np.abs(outs[a] - outs[b])
        return int(d.max()), float(d.mean())

    report["gap_mesh"] = gap("mesh", "one")
    report["gap_half_batch"] = gap("one_half_batch", "one")
    report["gap_mesh_f32"] = gap("mesh_f32", "one_f32")
    print(f"distributed: frame-parallel pipeline over "
          f"{report['mesh_devices']} on {card}: {FRAMES} frames, frame batch "
          f"{FRAME_BATCH} split {len(devices)} ways, bf16: "
          f"{report['mesh']['frames_per_s']:.2f} frames/s (mesh=None "
          f"{report['one']['frames_per_s']:.2f}); K1 "
          f"{report['mesh']['k1_per_frame_batch']:.0f} launches per frame "
          f"batch; frames against mesh=None (max, mean levels): bf16 "
          f"{report['gap_mesh']} (mesh=None at frame batch "
          f"{FRAME_BATCH // 2} against {FRAME_BATCH}: "
          f"{report['gap_half_batch']}), f32 {report['gap_mesh_f32']}",
          flush=True)
    assert outs["mesh"].shape == (FRAMES, 256, 256, 3)
    assert report["gap_mesh_f32"][0] <= 1, report["gap_mesh_f32"]
    assert report["gap_mesh"][0] <= max(report["gap_half_batch"][0], 1), (
        report["gap_mesh"], report["gap_half_batch"])
    assert report["gap_mesh"][1] <= 1.5 * report["gap_half_batch"][1] + 0.05
    assert report["mesh"]["k1_per_frame_batch"] == 32 * len(devices), report
    assert report["one"]["k1_per_frame_batch"] == 32, report
    return report


def distributed(torch, configs, Trainer, ReenactmentPipeline, seeded_nets,
                fa, k3, seed, card):
    """The distributed phase: world size 1 over NCCL through train.run,
    two ranks, remat, frame parallelism."""
    t0 = time.perf_counter()
    report = {"world1": dp_world1(torch, configs, fa, k3, seed, card)}
    torch.cuda.empty_cache()
    report["two_ranks"] = dp_two_ranks(torch, configs, Trainer, fa, k3, seed,
                                       card)
    torch.cuda.empty_cache()
    report["remat"] = remat_modes(torch, configs, Trainer, k3, seed, card)
    torch.cuda.empty_cache()
    report["frame_parallel"] = frame_parallel(
        torch, configs, ReenactmentPipeline, seeded_nets, fa, seed, card)
    report["seconds"] = time.perf_counter() - t0
    print(f"distributed: phase wall time {report['seconds']:.1f} s",
          flush=True)
    return report


# ---------------------------------------------------------------------------
# entry points: demo, test.py, animate.py, trained weights, metric networks
# ---------------------------------------------------------------------------

def image_like(torch, n, size, seed):
    """n seeded image-like size^2 RGB uint8 frames, NHWC (write_frame_cache's
    recipe: a random 8x8 field, bilinearly upsampled, plus a little
    noise)."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 8, 8)).astype(np.float32))
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bilinear")
    img = (img + 0.05 * torch.from_numpy(rng.randn(*img.shape)
                                         .astype(np.float32))).clamp(-1, 1)
    return ((img + 1) * 127.5).round().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().numpy()


def pipeline_kw(torch):
    """The main path's pipeline options: bf16, uint8 frames in and out."""
    return dict(relative=True, adapt_scale=True, frame_batch=FRAME_BATCH,
                compute_dtype=torch.bfloat16, u8_io=True, device="cuda")


def weights_round_trip(torch, configs, ReenactmentPipeline, seeded_nets,
                       seed):
    """The seeded flagship G and M written by training.export_params (G
    under params_ema, M under params) to build/chip_smoke and read back by
    demo.build_and_load (strict=True): the loaded pipeline's frames equal
    the in-memory pipeline's bit for bit, bf16 with uint8 out, on one
    frame batch. The directory is removed afterwards."""
    from synergize_motion_appearance_tpu_torch.demo import build_and_load
    from synergize_motion_appearance_tpu_torch.training import export_params

    cfg = configs.get("flagship_256")
    g, me = seeded_nets(cfg, seed)
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        paths = {"pretrain_network_g": os.path.join(work, "net_g.pth"),
                 "pretrain_network_motion_estimator":
                     os.path.join(work, "net_m.pth")}
        export_params(paths["pretrain_network_g"], g.state_dict(),
                      "params_ema")
        export_params(paths["pretrain_network_motion_estimator"],
                      me.state_dict(), "params")
        nbytes = sum(os.path.getsize(p) for p in paths.values())
        t0 = time.perf_counter()
        lg, lme = build_and_load(dict(cfg, path=paths), "cuda")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    src = image_like(torch, 1, 256, seed + 30)
    drv = image_like(torch, FRAME_BATCH, 256, seed + 31)
    want = ReenactmentPipeline(g, me, **pipeline_kw(torch)).animate(src, drv)
    got = ReenactmentPipeline(lg, lme, **pipeline_kw(torch)).animate(src,
                                                                     drv)
    assert got.shape == want.shape == (FRAME_BATCH, 256, 256, 3)
    assert np.array_equal(got, want), (
        "loaded weights give other frames: max diff "
        f"{np.abs(got.astype(int) - want.astype(int)).max()} levels")
    print(f"entry points: trained-weight round trip: {nbytes} bytes "
          f"written, build_and_load {load_s:.2f} s, {FRAME_BATCH} frames "
          f"bit-identical to the in-memory pipeline", flush=True)
    return {"bytes": nbytes, "load_s": load_s, "frames": FRAME_BATCH,
            "bit_identical": True}


def anchor_path(torch, configs, ReenactmentPipeline, seeded_nets, fa, seed,
                card):
    """find_best_frame_kp and then animate_with_anchor on ANCHOR_FRAMES
    image-like flagship frames, frame batch 16, bf16, uint8 in and out.
    Driving frame ANCHOR_AT is the source, so it is the anchor. F frames
    come out; the anchor's frame is animate(source, driving[anchor:])[0];
    the backward half is the reversed animate of the reversed prefix; K1
    runs 32 times per frame batch (counts set to 0 just before the call
    and read just after)."""
    from synergize_motion_appearance_tpu_torch.inference import (
        find_best_frame_kp,
    )

    g, me = seeded_nets(configs.get("flagship_256"), seed)
    pipe = ReenactmentPipeline(g, me, **pipeline_kw(torch))
    src = image_like(torch, 1, 256, seed + 32)
    drv = image_like(torch, ANCHOR_FRAMES, 256, seed + 33)
    drv[ANCHOR_AT] = src[0]
    # warm-up: first calls, and scipy's first import (1-2 s on an H100 host)
    pipe.animate(src, drv[:FRAME_BATCH])
    find_best_frame_kp(pipe, src, drv[:FRAME_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anchor = find_best_frame_kp(pipe, src, drv)
    find_s = time.perf_counter() - t0
    assert anchor == ANCHOR_AT, f"anchor {anchor}, want {ANCHOR_AT}"
    fa.reset_launches()
    t0 = time.perf_counter()
    out = pipe.animate_with_anchor(src, drv, anchor)
    animate_s = time.perf_counter() - t0
    launches, split = fa.launches, fa.split_launches
    n_batches = (math.ceil((ANCHOR_FRAMES - anchor) / FRAME_BATCH)
                 + math.ceil((anchor + 1) / FRAME_BATCH))
    assert out.shape == (ANCHOR_FRAMES, 256, 256, 3), out.shape
    assert out.dtype == np.uint8 and out.std() > 0
    assert launches == 32 * n_batches, (
        f"K1 launched {launches} times on the anchor path, want 32 per "
        f"frame batch x {n_batches}")
    assert split == 0, "the anchor path launched K2"
    fwd = pipe.animate(src, drv[anchor:])
    assert np.array_equal(out[anchor], fwd[0])
    assert np.array_equal(out[anchor:], fwd)
    bwd = pipe.animate(src, drv[:anchor + 1][::-1])
    assert np.array_equal(out[:anchor + 1], bwd[::-1])
    print(f"entry points: anchor path flagship-256 bf16: find_best_frame_kp "
          f"over {ANCHOR_FRAMES} frames {find_s:.3f} s (anchor {anchor}); "
          f"animate_with_anchor {animate_s:.3f} s = "
          f"{ANCHOR_FRAMES / animate_s:.2f} frames/s, {n_batches} frame "
          f"batches, K1 launches {launches} on {card}", flush=True)
    return {"frames": ANCHOR_FRAMES, "anchor": anchor, "find_s": find_s,
            "animate_s": animate_s,
            "frames_per_s": ANCHOR_FRAMES / animate_s,
            "frame_batches": n_batches, "k1_launches": launches,
            "k2_launches": split}


KP_HOST_BOUND = 1e-2  # keypoints, host vs device downsample, f32


def fast_io(torch, configs, ReenactmentPipeline, seeded_nets, seed):
    """--fast's device-side pieces: rgb_to_yuv420 on the card against the
    port on the CPU (within 1 level), and keypoints from float frames
    downsampled on the host (antialias_downsample_host, numpy, then bf16
    for the upload) against the detector's own downsample on the card, in
    f32 (within KP_HOST_BOUND). The I420 fetch and the uint8 host
    downsample need OpenCV, which the card's machine lacks: they are held
    by the CPU tests only."""
    from synergize_motion_appearance_tpu_torch.ops.color import (
        rgb_to_yuv420,
    )

    x = torch.from_numpy(np.random.RandomState(seed + 34).uniform(
        -1.05, 1.05, (FRAME_BATCH, 256, 256, 3)).astype(np.float32))
    on_card = rgb_to_yuv420(x.cuda()).cpu()
    on_cpu = rgb_to_yuv420(x)
    assert on_card.shape == (FRAME_BATCH, 384, 256)
    yuv_diff = int((on_card.int() - on_cpu.int()).abs().max())
    assert yuv_diff <= 1, f"rgb_to_yuv420 card vs CPU: {yuv_diff} levels"

    g, me = seeded_nets(configs.get("flagship_256"), seed)
    kw = dict(compute_dtype=torch.float32, device="cuda")
    device_ds = ReenactmentPipeline(g, me, **kw)
    host_ds = ReenactmentPipeline(g, me, host_kp_downsample=True, **kw)
    frames01 = image_like(torch, FRAME_BATCH, 256, seed + 35)
    frames_f = frames01.astype(np.float32) / 127.5 - 1.0
    with torch.no_grad():
        got = host_ds._kp_frames(frames_f)
        want = device_ds.estimate_kp(frames_f)
    kp_err = float((got["value"] - want["value"]).abs().max())
    assert kp_err <= KP_HOST_BOUND, f"host kp downsample: {kp_err}"
    print(f"entry points: --fast on the card: rgb_to_yuv420 card vs CPU "
          f"{yuv_diff} levels; keypoints from host-downsampled float frames "
          f"vs the detector's downsample, f32: max |diff| {kp_err:.3g} "
          f"(bound {KP_HOST_BOUND})", flush=True)
    return {"yuv_levels": yuv_diff, "kp_host_max_abs": kp_err,
            "kp_bound": KP_HOST_BOUND}


class SeededPairs:
    """A pairs dataset of seeded image-like frames, with the item keys of
    FramesMotionTransferTestDataset_PairsList (source and driving HWC
    float32 RGB in [-1, 1], frame_name): test.run's input on a machine
    without an image decoder."""

    def __init__(self, opt):
        import torch

        self.torch = torch
        self.n, self.size, self.seed = opt["pairs"], opt["gt_size"], \
            opt["seed"]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        f = image_like(self.torch, 2, self.size, self.seed + i)
        f = f.astype(np.float32) / 127.5 - 1.0
        return {"source": f[0], "driving": f[1], "frame_name": f"pair{i}"}


def test_run(torch, configs, fa, seed, card):
    """test.run (f32, one pair at a time) at the flagship config on the
    card over EVAL_PAIRS seeded pairs (SeededPairs, registered in the
    port's DATASET_REGISTRY), save_img false, PSNR/SSIM/L1: its results
    equal those of direct calls of the same networks on the same pairs, and
    K1 runs 32 times per pair. Then the tiny config's test.run on the card
    and on the CPU: result frames (taken where test.run would save them)
    within 1 level."""
    from synergize_motion_appearance_tpu_torch import test as port_test
    from synergize_motion_appearance_tpu_torch.demo import build_and_load
    from synergize_motion_appearance_tpu_torch.metrics import (
        calculate_l1, calculate_psnr, calculate_ssim,
    )
    from synergize_motion_appearance_tpu_torch.utils.img_util import arr2img
    from synergize_motion_appearance_tpu_torch.utils.options import (
        derive_paths,
    )
    from synergize_motion_appearance_tpu_torch.utils.registry import (
        DATASET_REGISTRY,
    )

    DATASET_REGISTRY.register(SeededPairs, name="ChipSmokeSeededPairs")
    work = os.path.join(ROOT, "build", "chip_smoke")
    metric_fns = {"psnr": calculate_psnr, "ssim": calculate_ssim,
                  "l1": calculate_l1}

    def opt_of(name, pairs, size, save_img):
        opt = configs.get(name)
        opt.update(name=f"chip-smoke-{name}", path={"save_path": work},
                   datasets={"test": dict(type="ChipSmokeSeededPairs",
                                          name="seeded", pairs=pairs,
                                          gt_size=size, seed=seed + 40)},
                   val={"save_img": save_img, "metrics": {
                       m: {"type": f"calculate_{m}", "crop_border": 0}
                       for m in metric_fns}})
        return derive_paths(opt, is_train=False)

    shutil.rmtree(work, ignore_errors=True)
    try:
        fa.reset_launches()
        t0 = time.perf_counter()
        results = port_test.run(opt_of("flagship_256", EVAL_PAIRS, 256,
                                       False), "cuda")["seeded"]
        run_s = time.perf_counter() - t0
        launches = fa.launches
        assert launches == 32 * EVAL_PAIRS, (
            f"K1 launched {launches} times in test.run, want 32 per pair")

        g, me = build_and_load(configs.get("flagship_256"), "cuda")
        g.eval()
        me.eval()
        ds = SeededPairs({"pairs": EVAL_PAIRS, "gt_size": 256,
                          "seed": seed + 40})
        direct = {m: 0.0 for m in metric_fns}
        pair_ms = []
        for i in range(EVAL_PAIRS):
            item = ds[i]
            s, d = (torch.from_numpy(item[k][None]).permute(0, 3, 1, 2)
                    .cuda() for k in ("source", "driving"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = g(s, me(d, s), w=1, inference=True)["out"]
            torch.cuda.synchronize()
            pair_ms.append((time.perf_counter() - t0) * 1e3)
            res = arr2img(out.permute(0, 2, 3, 1).cpu().numpy(),
                          rgb2bgr=True)
            gt = arr2img(item["driving"], rgb2bgr=True)
            for m, fn in metric_fns.items():
                direct[m] += fn(res, gt, 0)
        for m in metric_fns:  # summed, then averaged, as test.run does
            direct[m] /= EVAL_PAIRS
            assert results[m] == direct[m], (m, results[m], direct[m])

        frames = {}
        save_quad = port_test.save_quad
        for device in ("cpu", "cuda"):
            got = frames[device] = []
            port_test.save_quad = (
                lambda vis_dir, name, visual, result, source, driving:
                got.append(result))
            try:
                port_test.run(opt_of("tiny", 2, 64, True), device)
            finally:
                port_test.save_quad = save_quad
        tiny_levels = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                          for a, b in zip(frames["cpu"], frames["cuda"]))
        assert len(frames["cuda"]) == 2 and tiny_levels <= 1, tiny_levels
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"entry points: test.run flagship-256 f32 on the card, "
          f"{EVAL_PAIRS} pairs in {run_s:.2f} s (set-up included), "
          f"psnr {results['psnr']:.4f} ssim {results['ssim']:.4f} l1 "
          f"{results['l1']:.4f} equal to direct calls; direct forward per "
          f"pair {[round(t, 2) for t in pair_ms]} ms; K1 launches "
          f"{launches}; tiny test.run card vs CPU {tiny_levels} levels, on "
          f"{card}", flush=True)
    return {"pairs": EVAL_PAIRS, "run_s": run_s, "results": results,
            "pair_ms": pair_ms, "k1_launches": launches,
            "tiny_levels": tiny_levels}


def seeded_metric_net(torch, net, seed):
    """He-normal convolutions and linears, non-trivial BatchNorm affines and
    statistics, positive LPIPS heads (no metric weights are in the
    repository); on the CPU, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
                if name.startswith("lin"):
                    m.weight.abs_()
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=gen))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))
    return net.eval()


METRIC_REL = 1e-4  # card vs CPU, f32 without TF32: relative max error


def metric_nets(torch, seed, card):
    """The metric networks at their real input sizes, seeded weights, f32
    with TF32 off: FID's extract_features on 32 images of 256^2 (resized
    to 299; FID's batch), lpips_distance on 16 pairs of 256^2, embed_faces
    on 32 faces of 96^2. Each on the card against the port on the CPU
    (relative max error <= METRIC_REL), timed by CUDA events; then
    frechet_distance between two 32-image feature sets from the card."""
    from synergize_motion_appearance_tpu_torch.metrics.external import (
        activation_statistics, frechet_distance,
    )
    from synergize_motion_appearance_tpu_torch.metrics.inception import (
        FIDInceptionV3, extract_features,
    )
    from synergize_motion_appearance_tpu_torch.metrics.lpips import (
        LPIPSVgg, lpips_distance,
    )
    from synergize_motion_appearance_tpu_torch.metrics.openface import (
        OpenFaceNet, embed_faces,
    )

    def nchw01(n, size, s):
        return torch.from_numpy(image_like(torch, n, size, s)).permute(
            0, 3, 1, 2).float() / 255.0

    imgs = nchw01(32, 256, seed + 50)
    cases = [
        ("extract_features", FIDInceptionV3, extract_features, (imgs,)),
        ("lpips_distance", LPIPSVgg, lpips_distance,
         (nchw01(16, 256, seed + 51) * 2 - 1,
          nchw01(16, 256, seed + 52) * 2 - 1)),
        ("embed_faces", OpenFaceNet, embed_faces,
         (nchw01(32, 96, seed + 53)[:, [2, 1, 0]],)),
    ]
    report = {}
    feats = None
    for i, (name, cls, fn, args) in enumerate(cases):
        net = seeded_metric_net(torch, cls(), seed + 60 + i)
        with torch.no_grad():
            want = fn(net, *args).double()
            net = net.cuda()
            card_args = [a.cuda() for a in args]
            got = fn(net, *card_args)
            ms = time_ms(torch, lambda: fn(net, *card_args), iters=5)
        rel = float((got.double().cpu() - want).abs().max()
                    / want.abs().max())
        assert rel <= METRIC_REL, f"{name}: card vs CPU {rel:.3g}"
        shape = [tuple(a.shape) for a in args]
        print(f"entry points: {name} {shape} f32: card vs CPU relative max "
              f"error {rel:.3g} (bound {METRIC_REL}); {ms:.3f} ms on {card}",
              flush=True)
        report[name] = {"inputs": shape, "rel_err": rel, "ms": ms}
        if name == "extract_features":
            with torch.no_grad():
                other = extract_features(net, nchw01(32, 256, seed + 54)
                                         .cuda())
            feats = [got.cpu().double().numpy(), other.cpu().double().numpy()]
        del net
    fid = frechet_distance(*activation_statistics(feats[0]),
                           *activation_statistics(feats[1]))
    assert math.isfinite(fid) and fid > 0, fid
    print(f"entry points: frechet_distance of two 32-image feature sets "
          f"from the card: {fid:.6g}", flush=True)
    report["frechet_distance"] = fid
    return report


def entry_points(torch, configs, ReenactmentPipeline, seeded_nets, fa, seed,
                 card):
    """The entry-points phase: trained-weight round trip, anchor path,
    --fast pieces, test.run, metric networks; prints its wall time."""
    t0 = time.perf_counter()
    report = {
        "round_trip": weights_round_trip(torch, configs, ReenactmentPipeline,
                                         seeded_nets, seed)}
    torch.cuda.empty_cache()
    report["anchor_path"] = anchor_path(torch, configs, ReenactmentPipeline,
                                        seeded_nets, fa, seed, card)
    torch.cuda.empty_cache()
    report["fast_io"] = fast_io(torch, configs, ReenactmentPipeline,
                                seeded_nets, seed)
    torch.cuda.empty_cache()
    report["test_run"] = test_run(torch, configs, fa, seed, card)
    torch.cuda.empty_cache()
    report["metric_nets"] = metric_nets(torch, seed, card)
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    print(f"entry points: phase wall time {report['seconds']:.1f} s",
          flush=True)
    return report


# ---------------------------------------------------------------------------
# serving: exported artifacts (serving.py)
# ---------------------------------------------------------------------------

SWAP_SEED = 1  # the tiny weight swap's second seed, added to --seed


def graph_targets(torch, path):
    """The call targets of a saved program's graph, and its state_dict."""
    ep = torch.export.load(path)
    return ([str(n.target) for n in ep.graph.nodes
             if n.op == "call_function"], ep.state_dict)


def serving_swap(torch, configs, ReenactmentPipeline, seeded_nets, serving,
                 work, seed):
    """A tiny artifact (f32, uint8 out) exported on the card; a second
    seed's weights swapped in with load_weights, no export again: its
    frames match a live pipeline on those weights within 1 level."""
    cfg = configs.get("tiny")
    kw = dict(relative=True, adapt_scale=True, frame_batch=4,
              compute_dtype=torch.float32, u8_io=True, device="cuda")
    art = os.path.join(work, "tiny")
    serving.export_pipeline(ReenactmentPipeline(*seeded_nets(cfg, seed),
                                                **kw), art)
    stamp = {f: os.stat(os.path.join(art, f)).st_mtime_ns
             for f in os.listdir(art)}
    served = serving.load_serving_pipeline(art)
    src, drv = frames(1, 64, seed + 40), frames(6, 64, seed + 41)
    before = served.animate(src, drv)
    live = ReenactmentPipeline(*seeded_nets(cfg, seed + SWAP_SEED), **kw)
    served.load_weights(live.g_weights, live.m_weights)
    got, want = served.animate(src, drv), live.animate(src, drv)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    moved = float(np.abs(got.astype(np.int32) - before).mean())
    assert stamp == {f: os.stat(os.path.join(art, f)).st_mtime_ns
                     for f in os.listdir(art)}, "the swap touched a file"
    assert moved > 1.0, f"the swap did not change the frames ({moved})"
    assert diff.max() <= 1, f"swapped weights: {diff.max()} levels"
    print(f"serving: tiny weight swap without export: max |diff| "
          f"{diff.max()} levels against the live pipeline on seed "
          f"{seed + SWAP_SEED} (identical share "
          f"{float((diff == 0).mean()):.4f}; frames moved "
          f"{moved:.2f} levels on average)", flush=True)
    return {"max_diff_levels": int(diff.max()),
            "identical_share": float((diff == 0).mean()),
            "mean_levels_moved": moved}


def serving_path(torch, configs, ReenactmentPipeline, seeded_nets, fa, seed,
                 card):
    """The flagship pipeline of the main path (seeded weights, bf16, uint8
    in and out, frame batch 16) exported with serving.export_pipeline to
    build/chip_smoke_serving, loaded back with load_serving_pipeline and
    run on the main path's 64 frames: within 1 level of the live
    pipeline's frames, K1 32 times per frame batch from the exported gen
    program (counts set to 0 just before, read just after), no SDPA in
    that program, no weights in any program file. Then the tiny weight
    swap. Times export, load to first frame batch against build_and_load
    plus the first frame batch, and served against live frames/s (the two
    in turns). Then the two-device artifact (serving_two_device). The
    directory is removed afterwards."""
    from synergize_motion_appearance_tpu_torch import serving
    from synergize_motion_appearance_tpu_torch.demo import build_and_load

    cfg = configs.get("flagship_256")
    size, per_batch = cfg["network_g"]["img_size"], k1_per_train_step(
        cfg["network_g"])  # one forward's K1 launches
    src = frames(1, size, seed + 20)
    drv = frames(FRAMES, size, seed + 21)
    work = os.path.join(ROOT, "build", "chip_smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        live = ReenactmentPipeline(*seeded_nets(cfg, seed),
                                   **pipeline_kw(torch))
        art = os.path.join(work, "flagship")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serving.export_pipeline(live, art)
        export_s = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(art, f))
                 for f in sorted(os.listdir(art))}
        weight_bytes = sum(v.numel() * v.element_size() for w in (
            live.g_weights, live.m_weights) for v in w.values())
        k1_ops = {}
        for stage in serving._STAGES:
            targets, state = graph_targets(
                torch, os.path.join(art, f"{stage}.pt2"))
            assert not state, f"{stage}.pt2 holds {len(state)} weights"
            assert not any("scaled_dot_product" in t for t in targets), (
                f"{stage}.pt2 calls SDPA")
            k1_ops[stage] = targets.count(
                "samt.fused_attention_packed.default")
        assert k1_ops == {"kp1": 0, "kpN": 0, "enc": 0,
                          "gen": per_batch}, k1_ops
        programs = sum(v for f, v in sizes.items() if f.endswith(".pt2"))
        assert sizes["params.pt"] < 1.01 * weight_bytes + 2**20, (
            sizes["params.pt"], weight_bytes)
        assert programs < 0.25 * weight_bytes, (programs, weight_bytes)

        # load to first frame batch: served, then live from build_and_load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = serving.load_serving_pipeline(art)
        served.animate(src, drv[:FRAME_BATCH])
        served_first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g, me = build_and_load(cfg, "cuda")
        ReenactmentPipeline(g, me, **pipeline_kw(torch)).animate(
            src, drv[:FRAME_BATCH])
        live_first_s = time.perf_counter() - t0
        del g, me

        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = served.animate(src, drv)
        first_run_s = time.perf_counter() - t0
        launches, split = fa.launches, fa.split_launches
        n_batches = math.ceil(FRAMES / FRAME_BATCH)
        assert launches == per_batch * n_batches, (
            f"served K1 launches {launches}, want {per_batch} per frame "
            f"batch x {n_batches}")
        assert split == 0, "the served path launched K2"
        want = live.animate(src, drv)
        assert out.shape == want.shape == (FRAMES, size, size, 3)
        assert out.dtype == np.uint8 and out.std() > 0
        diff = np.abs(out.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"served vs live: {diff.max()} levels"
        # frames/s in turns: live, served, served, live
        times = {"live": [], "served": []}
        for name in ("live", "served", "served", "live"):
            pipe = live if name == "live" else served
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.animate(src, drv)
            times[name].append(time.perf_counter() - t0)
        fps = {k: [FRAMES / t for t in v] for k, v in times.items()}
        swap = serving_swap(torch, configs, ReenactmentPipeline,
                            seeded_nets, serving, work, seed)
        two_device = serving_two_device(
            torch, configs, ReenactmentPipeline, seeded_nets, serving, fa,
            live, src, drv, work, seed, card, per_batch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same = float((diff == 0).mean())
    print(f"serving: flagship-256 bf16 uint8 artifact: {sizes} bytes "
          f"(weights {weight_bytes} bytes), export {export_s:.2f} s; "
          f"load to first frame batch {served_first_s:.2f} s against "
          f"build_and_load + first frame batch {live_first_s:.2f} s; "
          f"served vs live frames: max |diff| {diff.max()} levels, "
          f"identical share {same:.6f}; K1 launches {launches} "
          f"({k1_ops['gen']} samt ops in gen, no SDPA); frames/s served "
          f"{[round(f, 2) for f in fps['served']]} vs live "
          f"{[round(f, 2) for f in fps['live']]} on {card}", flush=True)
    return {"bytes": sizes, "weight_bytes": weight_bytes,
            "export_s": export_s, "served_load_to_first_batch_s":
            served_first_s, "live_build_to_first_batch_s": live_first_s,
            "max_diff_levels": int(diff.max()), "identical_share": same,
            "k1_launches": launches, "k2_launches": split,
            "k1_ops": k1_ops, "first_run_s": first_run_s,
            "frames_per_s": fps, "swap": swap, "two_device": two_device}


SR_STEPS = 5        # timed SRModel steps of the VQGAN stage-1 path
SR_BATCH = 2        # its batch of 256x256 frames
SR_OUT_REL = 1e-4   # full-width f32 forwards and losses, card vs CPU:
#                     max error over the largest magnitude
SR_GRAD_REL = 1e-3  # penalties' gradients to D, card vs CPU, 2-norm


def sr_frames(torch, n, size, seed):
    """n seeded image-like frames in [-1, 1], NHWC float32 numpy."""
    return image_like(torch, n, size, seed).astype(np.float32) / 127.5 - 1.0


def max_rel(torch, got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def samt_launches(fa, k3):
    return {"k1": fa.launches, "k2": fa.split_launches, "k3": k3.launches,
            "k4": k3.nhwc_launches}


def sr_train(torch, configs, build_model, fa, k3, seed, card):
    """VQGAN stage-1 training at full width (configs.FLAGSHIP_VQGAN_SR):
    build_model -> feed_data -> SR_STEPS optimize_parameters on an
    identity target, timed by the host clock with the kernel counts set to
    0 just before and read just after; then test() and
    nondist_validation on the card. l_pix finite and falling; no samt
    kernel launched (the JAX VQAutoEncoder reaches no Pallas kernel)."""
    cfg = configs.get("flagship_vqgan_sr")
    model = build_model(cfg, device="cuda")
    data = sr_frames(torch, SR_BATCH, 256, seed + 90)
    model.feed_data({"lq": data, "gt": data})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    k3.reset_launches()
    times, l_pix = [], []
    for it in range(1, SR_STEPS + 1):
        t0 = time.perf_counter()
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        l_pix.append(model.get_current_log()["l_pix"])
    launches = samt_launches(fa, k3)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(v) for v in l_pix), l_pix
    assert l_pix[-1] < l_pix[0], l_pix
    assert not any(launches.values()), launches
    out = model.test()
    assert out.shape == (SR_BATCH, 3, 256, 256)
    assert torch.isfinite(out).all()
    val = model.nondist_validation([{"lq": data, "gt": data}], SR_STEPS)
    assert math.isfinite(val["psnr"]), val
    ms = float(np.median(times))
    print(f"sr_model: VQGAN stage-1 (SRModel over VQAutoEncoder, 256^2, "
          f"batch {SR_BATCH}, f32) {ms:.2f} ms/step median of {SR_STEPS} "
          f"(host clock; first {times[0]:.2f} ms), peak "
          f"{peak / 2 ** 30:.2f} GiB, l_pix {l_pix[0]:.5f} -> "
          f"{l_pix[-1]:.5f}, EMA PSNR {val['psnr']:.3f} dB, samt launches "
          f"{launches} on {card}", flush=True)
    del model
    return {"step_ms": times, "ms_per_step_median": ms, "peak_bytes": peak,
            "l_pix": l_pix, "psnr": val["psnr"], "launches": launches}


def sr_forwards(torch, configs, build_network, seed):
    """One full-width f32 forward, batch 1, of VQAutoEncoder and
    AutoEncoder_MSDecoder (configs.FLAGSHIP_VQGAN_SR's widths) on the card
    against the same module on the CPU. The codebook is drawn at the
    latents' scale: at its default init (+-1/1024) the nearest-entry
    distances of a latent tie to float32 rounding, so the card and the
    CPU would pick among near-equal entries."""
    g_cfg = configs.get("flagship_vqgan_sr")["network_g"]
    x = torch.from_numpy(sr_frames(torch, 1, 256, seed + 91)).permute(
        0, 3, 1, 2).contiguous()
    torch.manual_seed(seed + 92)
    vq = build_network(g_cfg).eval()
    with torch.no_grad():
        z = vq.encoder(x)[0]
        gen = torch.Generator().manual_seed(seed + 93)
        vq.quantize.embedding.weight.copy_(
            torch.randn(vq.quantize.embedding.weight.shape, generator=gen)
            * z.std())
        want, loss_cpu, st_cpu = vq(x)
        got, loss_card, st_card = vq.cuda()(x.cuda())
    idx_cpu = st_cpu["min_encoding_indices"]
    idx_card = st_card["min_encoding_indices"].cpu()
    equal = bool(torch.equal(idx_cpu, idx_card))
    report = {"vq_autoencoder": {
        "max_rel_err": max_rel(torch, got, want),
        "codebook_loss_rel_err": abs(float(loss_card) - float(loss_cpu))
        / abs(float(loss_cpu)),
        "indices_equal": equal,
        "distinct_indices": int(idx_cpu.unique().numel())}}
    del vq
    ms_cfg = {k: v for k, v in g_cfg.items() if k != "codebook_size"}
    ms_cfg["type"] = "AutoEncoder_MSDecoder"
    torch.manual_seed(seed + 94)
    ms = build_network(ms_cfg).eval()
    with torch.no_grad():
        want = ms(x)
        got = ms.cuda()(x.cuda())
    report["autoencoder_ms_decoder"] = {"max_rel_err": max_rel(torch, got,
                                                               want)}
    del ms
    print(f"sr_model forwards, f32 card vs CPU at 256^2: VQAutoEncoder "
          f"{report['vq_autoencoder']['max_rel_err']:.3e} (indices equal "
          f"{equal}, {report['vq_autoencoder']['distinct_indices']} "
          f"distinct), AutoEncoder_MSDecoder "
          f"{report['autoencoder_ms_decoder']['max_rel_err']:.3e}",
          flush=True)
    assert equal, "VQAutoEncoder: other codebook indices on the card"
    assert report["vq_autoencoder"]["max_rel_err"] <= SR_OUT_REL, report
    assert report["vq_autoencoder"]["codebook_loss_rel_err"] <= SR_OUT_REL
    assert report["autoencoder_ms_decoder"]["max_rel_err"] <= SR_OUT_REL, \
        report
    return report


def sr_losses(torch, build_network, seed):
    """PerceptualLoss (with a style term) over VGG19Features,
    VGGFeatureExtractor (vgg19, relu1_1 ... relu5_1) at 256^2, and
    r1_penalty and gradient_penalty_loss over the flagship
    VQGANDiscriminator with their gradients to D's weights (a double
    backward), each on the card against the CPU."""
    from synergize_motion_appearance_tpu_torch import losses as tl
    from synergize_motion_appearance_tpu_torch.models import VGG19Features

    x = torch.from_numpy(sr_frames(torch, 2, 256, seed + 95)).permute(
        0, 3, 1, 2).contiguous()
    y = torch.from_numpy(sr_frames(torch, 2, 256, seed + 96)).permute(
        0, 3, 1, 2).contiguous()
    report = {}
    torch.manual_seed(seed + 97)
    vgg = VGG19Features().eval().requires_grad_(False)
    perc = tl.build_loss({"type": "PerceptualLoss", "layer_weights": {
        "conv1_2": 0.1, "relu2_1": 0.1, "conv3_4": 1.0, "relu4_1": 1.0,
        "conv5_4": 1.0}, "perceptual_weight": 1.0, "style_weight": 50.0,
        "criterion": "l1", "range_norm": True})
    with torch.no_grad():
        want = perc(vgg, x[:1], y[:1])
        vgg_card = vgg.cuda()
        got = perc(vgg_card, x[:1].cuda(), y[:1].cuda())
    report["perceptual_values"] = {"cpu": [float(w) for w in want],
                                   "card": [float(g) for g in got]}
    report["perceptual"] = max(
        abs(float(g) - float(w)) / abs(float(w)) for g, w in zip(got, want))
    del vgg, vgg_card
    torch.manual_seed(seed + 98)
    ext = build_network({"type": "VGGFeatureExtractor", "layer_name_list": [
        "relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"],
        "vgg_type": "vgg19"}).eval()
    with torch.no_grad():
        want = ext(x[:1])
        got = ext.cuda()(x[:1].cuda())
    report["vgg_feature_extractor"] = max(
        max_rel(torch, got[k], want[k]) for k in want)
    del ext
    torch.manual_seed(seed + 99)
    d = build_network({"type": "VQGANDiscriminator", "nc": 3, "ndf": 64,
                       "n_layers": 4}).eval()

    # WGAN-GP's blend weights: one CPU draw, given to both sides
    alpha = torch.rand((x.shape[0], 1, 1, 1),
                       generator=torch.Generator().manual_seed(seed + 100))

    def penalties(net, real, fake, device):
        params = list(net.parameters())
        gen = torch.Generator(device=device).manual_seed(seed + 101)
        r1 = tl.r1_penalty(net, real)
        with mock.patch.object(tl, "_draw_alpha",
                               lambda n, g, dev, dt: alpha.to(dev, dt)):
            gp = tl.gradient_penalty_loss(net, real, fake, gen)
        grads = [torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            v, params, allow_unused=True) if g is not None]).cpu()
            for v in (r1, gp)]
        return [float(r1.detach()), float(gp.detach())], grads

    want, gwant = penalties(d, x, y, "cpu")
    got, ggot = penalties(d.cuda(), x.cuda(), y.cuda(), "cuda")
    report["r1_penalty"] = abs(got[0] - want[0]) / abs(want[0])
    report["gradient_penalty"] = abs(got[1] - want[1]) / abs(want[1])
    report["penalty_grad_rel_2norm"] = [
        float((g - w).norm() / w.norm()) for g, w in zip(ggot, gwant)]
    print(f"sr_model losses, f32 card vs CPU at 256^2: PerceptualLoss "
          f"(+style) {report['perceptual']:.3e}, VGGFeatureExtractor "
          f"{report['vgg_feature_extractor']:.3e}, r1 "
          f"{report['r1_penalty']:.3e}, WGAN-GP "
          f"{report['gradient_penalty']:.3e}, their gradients to D "
          f"{report['penalty_grad_rel_2norm']}", flush=True)
    for k in ("perceptual", "vgg_feature_extractor", "r1_penalty",
              "gradient_penalty"):
        assert report[k] <= SR_OUT_REL, (k, report[k])
    assert max(report["penalty_grad_rel_2norm"]) <= SR_GRAD_REL, report
    return report


# tests/test_sr_model.py's model: the 32x32 AutoEncoder with nf 8
TINY_SR = {
    "model_type": "SRModel", "is_train": True, "manual_seed": 0,
    "network_g": {"type": "AutoEncoder", "img_size": 32, "nf": 8,
                  "ch_mult": [1, 2], "res_blocks": 1,
                  "attn_resolutions": [8], "emb_dim": 16},
    "train": {"optim_g": {"type": "Adam", "lr": 1e-3},
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
              "ema_decay": 0.99},
}


def sr_tiny_step(torch, build_model, seed):
    """One tiny SRModel step (TINY_SR) on the card against the CPU from
    the same seeded weights, with tests/test_torch_sr_model.py's bounds:
    logs within 1e-5 relative; the gradient, from the Adam first moments,
    within 1e-3 in the 2-norm and per leaf within 1e-3 of the leaf's
    largest entry plus a floor of 2e-5 of the network's; weights and EMA
    within 2 lr, and within 1e-6 on 0.999 of the entries whose gradient
    is above the floor."""
    lr, b1 = TINY_SR["train"]["optim_g"]["lr"], 0.9
    data = sr_frames(torch, 2, 32, seed + 102)
    models = [build_model(TINY_SR, device=dev) for dev in ("cpu", "cuda")]
    for m in models:
        m.feed_data({"lq": data, "gt": data})
        m.optimize_parameters(1)
    cpu, card = models
    for k, v in cpu.get_current_log().items():
        assert abs(card.get_current_log()[k] - v) <= 1e-5 * abs(v), k
    grads = [{k: v.cpu() / (1 - b1) for k, v in m.adam_state.mu.items()}
             for m in models]
    floor = 2e-5 * max(float(g.abs().max()) for g in grads[0].values())
    worst_leaf = 0.0
    for k, w in grads[0].items():
        err = float((grads[1][k] - w).abs().max())
        bound = 1e-3 * float(w.abs().max()) + floor
        worst_leaf = max(worst_leaf, err / bound)
    num = sum(float(((grads[1][k] - w) ** 2).sum())
              for k, w in grads[0].items())
    den = sum(float((w ** 2).sum()) for w in grads[0].values())
    rel = math.sqrt(num / den)
    shares = {}
    for what in ("params", "ema"):
        if what == "params":
            a, b = (dict(m.net_g.named_parameters()) for m in models)
        else:
            a, b = cpu.ema, card.ema
        diffs = torch.cat([(b[k].detach().cpu() - a[k].detach()).abs()
                           .reshape(-1) for k in a])
        above = torch.cat([(grads[0][k].abs() > floor).reshape(-1)
                           for k in a])
        assert float(diffs.max()) <= 2 * lr * (1 + 1e-3), (what, diffs.max())
        shares[what] = float((diffs[above] <= 1e-6).float().mean())
    print(f"sr_model tiny step, f32 card vs CPU: gradient "
          f"{rel:.3e} relative 2-norm, worst leaf {worst_leaf:.2f} of its "
          f"bound, entries within 1e-6 {shares}", flush=True)
    assert rel <= 1e-3, rel
    assert worst_leaf <= 1.0, worst_leaf
    assert min(shares.values()) >= 0.999, shares
    return {"grad_rel_2norm": rel, "worst_leaf_over_bound": worst_leaf,
            "share_within_1e6": shares}


def sr_vgg_weights(torch, configs, Trainer, seed):
    """train.vgg_weights: the flagship Trainer built on the card with the
    key pointing at a .npz that tools/convert_vgg_weights.py's save_npz
    wrote from random VGG19 weights holds that file's tensors bit for bit
    (and its bf16 copy their cast); an absent path raises and names it."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from convert_vgg_weights import save_npz, torch_vgg_to_flax

    from synergize_motion_appearance_tpu_torch.models import VGG19Features
    from synergize_motion_appearance_tpu_torch.weights import vgg_state_dict

    work = os.path.join(ROOT, "build", "chip_smoke_vgg")
    os.makedirs(work, exist_ok=True)
    try:
        torch.manual_seed(seed + 103)
        params = torch_vgg_to_flax({k: v.numpy() for k, v in
                                    VGG19Features().state_dict().items()})
        path = os.path.join(work, "vgg19.npz")
        save_npz(params, path)
        want = vgg_state_dict(params)
        cfg = configs.get("flagship_train")
        cfg["train"]["vgg_weights"] = path
        tr = Trainer(cfg, device="cuda", seed=seed)
        got, got_c = tr.vgg.state_dict(), tr.vgg_c.state_dict()
        for k, w in want.items():
            assert torch.equal(got[k].cpu(), w), k
            assert torch.equal(got_c[k].cpu(), w.to(got_c[k].dtype)), k
        del tr
        missing = os.path.join(work, "missing.npz")
        cfg["train"]["vgg_weights"] = missing
        try:
            Trainer(cfg, device="cuda", seed=seed)
        except RuntimeError as e:
            assert missing in str(e), e
        else:
            raise AssertionError("an absent train.vgg_weights did not raise")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"sr_model vgg_weights: the flagship Trainer holds the file's "
          f"{len(want)} tensors bit for bit; an absent file raises",
          flush=True)
    return {"tensors": len(want), "absent_raises": True}


def sr_model(torch, configs, fa, k3, seed, card):
    """VQGAN stage-1 training (SRModel over VQAutoEncoder) at full width,
    the forwards and losses of its family on the card against the CPU, a
    tiny SRModel step against the CPU, and train.vgg_weights."""
    from synergize_motion_appearance_tpu_torch.model_api import build_model
    from synergize_motion_appearance_tpu_torch.models import build_network
    from synergize_motion_appearance_tpu_torch.training import Trainer

    t0 = time.perf_counter()
    report = {"train": sr_train(torch, configs, build_model, fa, k3, seed,
                                card)}
    torch.cuda.empty_cache()
    report["forwards"] = sr_forwards(torch, configs, build_network, seed)
    report["losses"] = sr_losses(torch, build_network, seed)
    report["tiny_step"] = sr_tiny_step(torch, build_model, seed)
    torch.cuda.empty_cache()
    report["vgg_weights"] = sr_vgg_weights(torch, configs, Trainer, seed)
    report["wall_s"] = time.perf_counter() - t0
    print(f"sr_model: phase {report['wall_s']:.1f} s on {card}", flush=True)
    return report


# ---------------------------------------------------------------------------
# the last train-step options and the generator's telemetry
# ---------------------------------------------------------------------------

OPTION_DECAY = 1e-4  # every optimizer's weight_decay in train_options
OPTION_STEPS = 3     # timed flagship steps with the options, after 1 warm-up
OPTION_TINY_STEPS = 3  # tiny card-vs-CPU steps with the options, D on


def options_cfg(configs, name):
    """Config ``name`` with a fixed GAN weight (use_adaptive_weight
    false) and Adam's weight decay OPTION_DECAY on all three
    optimizers."""
    cfg = configs.get(name)
    t = cfg["train"]
    t["use_adaptive_weight"] = False
    for key in ("optim_g", "optim_motion", "optim_d"):
        t[key] = dict(t.get(key, t["optim_g"]), weight_decay=OPTION_DECAY)
    return cfg


def telemetry_step(torch, tr, batch, gen, fa, k3):
    """One train step whose generator forward runs with telemetry=True:
    its ms, K1 and K3 launches, the forward's outputs (before the
    trainer's float32 cast) and the tensor the first appearance
    compensation took."""
    net = tr.net_g
    real_forward, real_comp = net.forward, net.app_codebook_compensation
    seen, outs = [], []

    def forward(*args, **kwargs):
        outs.append(real_forward(*args, telemetry=True, **kwargs))
        return outs[-1]

    def compensation(feat, motion):
        seen.append(feat)
        return real_comp(feat, motion)

    fa.reset_launches()
    k3.reset_launches()
    with mock.patch.object(net, "forward", forward), \
            mock.patch.object(net, "app_codebook_compensation",
                              compensation):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = tr.train_step(batch, generator=gen)
        torch.cuda.synchronize()
    return {"ms": 1e3 * (time.perf_counter() - t0), "k1": fa.launches,
            "k3": k3.launches, "logs": logs, "out": outs[-1],
            "first_comp_input": seen[0]}


def plain_step_ms(torch, tr, batch, gen):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def shapes_of(entries):
    return [[list(t.shape) for t in e] if isinstance(e, tuple)
            else list(e.shape) for e in entries]


# the tiny check's decays, large enough that the decay term lr * wd * p
# lies far above float32's rounding of the update (the CPU test's too)
TINY_DECAY = {"optim_g": 0.5, "optim_motion": 0.25, "optim_d": 1.0}


def assert_decayed_update(torch, before, after, lrs, betas, decays,
                          eps=1e-8):
    """Each network's weights after a step are its weights before it
    less lr * (the bias-corrected Adam direction from its new moments +
    wd * p), in float64 from the float32 states, within 4 float32 ulps of
    the weight and 1e-6 of lr; and the decay term lies above that bound
    on most entries, so a missing or another optimizer's decay fails.
    Returns the worst difference over its bound."""
    b1, b2 = betas
    worst = 0.0
    for net in ("g", "m", "d"):
        count = after[net + "_count"]
        bc1 = 1.0 - float(np.float32(b1) ** np.float32(count))
        bc2 = 1.0 - float(np.float32(b2) ** np.float32(count))
        lr, wd = lrs[net], decays[net]
        over, seen = [], []
        for k, mu in after[net + "_mu"].items():
            p0 = before[net][k].double()
            u = (mu.double() / bc1) / (
                (after[net + "_nu"][k].double() / bc2).sqrt() + eps)
            want = p0 - lr * (u + wd * p0)
            tol = 4 * 2.0 ** -23 * p0.abs() + 4e-6 * lr
            over.append(((after[net][k].double() - want).abs() / tol).flatten())
            seen.append((lr * wd * p0.abs() > 10 * tol).flatten())
        over, seen = torch.cat(over), torch.cat(seen)
        assert float(over.max()) <= 1.0, (net, float(over.max()))
        assert float(seen.float().mean()) > 0.5, (net, "decay not visible")
        worst = max(worst, float(over.max()))
    return worst


def tiny_options_parity(torch, configs, Trainer, sample_random_tps, k3,
                        seed):
    """TINY_TRAIN in float32 with the fixed GAN weight, TINY_DECAY and
    net_d_start_iter -1 (the GAN term and D's decayed update at every
    step): OPTION_TINY_STEPS steps from the init on the card and on the
    CPU, each from the CPU's state (the adaptive weight's probe patched
    to raise). Every step: the logs within tiny_train_parity's bounds,
    d_weight 0.8; the card's weights after the update its own Adam
    direction and decay (assert_decayed_update); every weight within 2 lr
    of the CPU's and each network's gradient within DP_GROSS_GAP. Each
    network holds compare_updates' 2-norm bounds and 0.999 update share
    at one step at least, as the two-rank step does: with the GAN term
    on, a single float32 step is as ill-conditioned as the two-rank one
    (measured on an H100 with these options: G 1.2e-2 from the CPU in
    2-norm at one of four steps, its worst leaf 22.6 times the leaf
    bound, with no nearest-codebook pick differing between the two
    devices; without the options the init step's worst leaves lay 1.12
    (G) and 1.49 (M) times the leaf bound, the 2-norms within theirs;
    PERF.md §6, PR 12)."""
    cfg = configs.get("tiny_train")
    t = cfg["train"]
    t["use_adaptive_weight"] = False
    t["net_d_start_iter"] = -1
    for key, wd in TINY_DECAY.items():
        t[key] = dict(t.get(key, t["optim_g"]), weight_decay=wd)
    decays = {"g": TINY_DECAY["optim_g"], "m": TINY_DECAY["optim_motion"],
              "d": TINY_DECAY["optim_d"]}
    gen = torch.Generator().manual_seed(seed + 32)
    tp = t["equivariance_opt"]["transform_params"]
    trainers = {d: Trainer(cfg, device=d, seed=seed) for d in ("cpu", "cuda")}
    batch = smooth_train_batch(torch, 64, seed + 33)
    batches = {d: {k: v.to(d) for k, v in batch.items()} for d in trainers}
    betas = [float(b) for b in t["optim_g"]["betas"]]
    worst_log, worst_decay, launches = 0.0, 0.0, 0
    gaps, off_bounds, held = [], [], {}
    for i in range(OPTION_TINY_STEPS):
        w = sample_random_tps(gen, TRAIN_BATCH, tp["sigma_affine"],
                              tp["sigma_tps"], tp["points_tps"])
        sync_trainer(trainers["cpu"], trainers["cuda"])
        before = train_state(trainers["cpu"])
        cpu_tr = trainers["cpu"]
        step = cpu_tr.state.step
        lrs = {"g": cpu_tr.lr_g(step), "m": cpu_tr.lr_m(step),
               "d": cpu_tr.lr_d(step)}
        logs = {}
        for d, tr in trainers.items():
            k3.reset_launches()
            with mock.patch.object(tr, "_probe_d_weight",
                                   side_effect=AssertionError("probe ran")):
                logs[d] = {k: float(v) for k, v in
                           tr.train_step(batches[d], tps=w).items()}
            launches += k3.launches if d == "cuda" else 0
        cpu, card = train_state(trainers["cpu"]), train_state(
            trainers["cuda"])
        worst_decay = max(worst_decay, assert_decayed_update(
            torch, before, card, lrs, betas, decays))
        grads, step_gaps = gradient_gaps(before, cpu, card, betas)
        gaps.append(step_gaps)
        for net, gap in step_gaps.items():
            assert (gap["rel_norm"] <= DP_GROSS_GAP and gap["nu_rel_norm"]
                    <= 2 * DP_GROSS_GAP), (i, net, gap)
        shares = {}
        assert_updates_close(torch, cpu, card, grads, max(lrs.values()),
                             min_share=None, shares=shares)
        missed = bounds_missed(step_gaps, shares)
        for key in set(step_gaps) | set(shares):
            held.setdefault(key, []).append(key not in missed)
        if missed:
            off_bounds.append({"step": i + 1, "missed": missed})
        assert sorted(logs["cpu"]) == sorted(logs["cuda"])
        for k, v in logs["cpu"].items():
            err = abs(logs["cuda"][k] - v)
            worst_log = max(worst_log, err / (abs(v) + 1e-1))
            assert err <= 1e-3 * abs(v) + 1e-4, (k, logs["cuda"][k], v)
        assert logs["cuda"]["d_weight"] == np.float32(0.8), logs["cuda"]
    assert all(any(steps) for steps in held.values()), (held, off_bounds)
    assert launches > 0, "tiny training on the card missed K3"
    return {"steps": OPTION_TINY_STEPS, "worst_log_rel_diff": worst_log,
            "worst_decayed_update_over_bound": worst_decay,
            "gradient_gaps": gaps, "steps_off_bounds": off_bounds,
            "k3_launches": launches}


def train_options(torch, configs, Trainer, sample_random_tps, fa, k3, seed,
                  card, plain_ms):
    """The flagship Trainer (options/train.yml, batch 2, bf16,
    net_d_start_iter 1) with use_adaptive_weight false and weight_decay
    OPTION_DECAY on its three optimizers: one warm-up step, then
    OPTION_STEPS timed steps, each with the kernel counts set to 0 just
    before it and read just after (K1 and K3 as train_path; the adaptive
    weight's probe patched to raise, so it never runs; d_weight the fixed
    0.8 once D is on); the tiny card step against the CPU's with the same
    options; then steps with the generator's telemetry on and off in
    turns (off, on, on, off): ms each, K1 and K3 of the telemetry steps,
    the four lists' lengths and shapes, and app_before_comp_list[0] being
    the tensor the first appearance compensation took."""
    t_phase = time.perf_counter()
    cfg = options_cfg(configs, "flagship_train")
    cfg["train"]["net_d_start_iter"] = 1
    g_cfg = cfg["network_g"]
    k1_per, k3_per = (k1_per_train_step(g_cfg),
                      2 * sum(k3_forward_convs(g_cfg).values()))
    tr = Trainer(cfg, device="cuda", seed=seed)
    assert not tr.use_adaptive_weight
    assert all(a.weight_decay == OPTION_DECAY
               for a in (tr.adam_g, tr.adam_m, tr.adam_d))
    batch = train_batch(torch, 256, seed + 40, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with mock.patch.object(tr, "_probe_d_weight",
                           side_effect=AssertionError("probe ran")):
        tr.train_step(batch, generator=gen)
        for _ in range(OPTION_STEPS):
            fa.reset_launches()
            k3.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = tr.train_step(batch, generator=gen)
            torch.cuda.synchronize()
            steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                          "k1": fa.launches, "k3": k3.launches,
                          "k2": fa.split_launches, "k4": k3.nhwc_launches,
                          "logs": {k: float(v) for k, v in logs.items()}})
    peak = torch.cuda.max_memory_allocated()
    for i, st in enumerate(steps, start=1):
        for k, v in st["logs"].items():
            assert math.isfinite(v), (i, k, v)
        assert st["logs"]["step_skipped_nonfinite"] == 0.0, i
        want = np.float32(0.8) if i >= 2 else 0.0
        assert st["logs"]["d_weight"] == want, (i, st["logs"]["d_weight"])
        assert (st["k1"], st["k3"]) == (k1_per, k3_per), st
        assert st["k2"] == st["k4"] == 0, st
    med = float(np.median([st["ms"] for st in steps]))
    tiny = tiny_options_parity(torch, configs, Trainer, sample_random_tps,
                               k3, seed)

    times = {"off": [], "on": []}
    tele = None
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            tele = telemetry_step(torch, tr, batch, gen, fa, k3)
            times["on"].append(tele["ms"])
            assert (tele["k1"], tele["k3"]) == (k1_per, k3_per), (
                tele["k1"], tele["k3"])
        else:
            times["off"].append(plain_step_ms(torch, tr, batch, gen))
    out = tele["out"]
    lists = {k: shapes_of(out[k]) for k in (
        "app_before_comp_list", "app_comp_list", "deform_feat_list",
        "app_recon_list")}
    net = tr.net_g
    n_app = 1 + sum(r <= max(net.connect_app) for r in net.connect)
    assert len(lists["app_before_comp_list"]) == len(
        lists["app_comp_list"]) == n_app, lists
    assert len(lists["deform_feat_list"]) == 1 + len(net.connect), lists
    assert len(lists["app_recon_list"]) == len(net.connect_app), lists
    assert out["app_before_comp_list"][0] is tele["first_comp_input"]
    for key in ("app_before_comp_list", "app_comp_list",
                "deform_feat_list"):
        for t in out[key]:
            assert bool(torch.isfinite(t).all()), key
    report = {
        "config": "flagship_train, use_adaptive_weight false, weight_decay "
                  f"{OPTION_DECAY} (optim_g, optim_motion, optim_d), "
                  "net_d_start_iter 1",
        "step_ms": [st["ms"] for st in steps], "step_ms_median": med,
        "train_path_step_ms_median": plain_ms,
        "max_memory_allocated_bytes": peak,
        "k1_launches_per_step": k1_per, "k3_launches_per_step": k3_per,
        "k1_launches": sum(st["k1"] for st in steps),
        "k3_launches": sum(st["k3"] for st in steps),
        "logs": [st["logs"] for st in steps], "tiny": tiny,
        "telemetry": {"step_ms_on": times["on"], "step_ms_off": times["off"],
                      "k1_launches": tele["k1"], "k3_launches": tele["k3"],
                      "lists": lists,
                      "first_entry_is_compensation_input": True},
        "wall_s": time.perf_counter() - t_phase}
    print(f"train_options: flagship_train bf16 batch {TRAIN_BATCH}, "
          f"use_adaptive_weight false, weight_decay {OPTION_DECAY} on all "
          f"three optimizers, on {card}: {OPTION_STEPS} steps after 1 "
          f"warm-up, median {med:.2f} ms/step "
          f"({[round(st['ms'], 2) for st in steps]}) against train_path's "
          f"{plain_ms:.2f}; K1 {k1_per} and K3 {k3_per} launches per step; "
          f"d_weight 0.8 fixed once D is on, no probe; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes)", flush=True)
    print(f"  tiny f32 with the options (decays {TINY_DECAY}), D on, "
          f"{OPTION_TINY_STEPS} steps card vs CPU, each from the CPU's "
          f"state: logs worst |diff| / (|cpu| + 0.1) "
          f"{tiny['worst_log_rel_diff']:.3e}; the card's updates its own "
          f"Adam direction + decay within "
          f"{tiny['worst_decayed_update_over_bound']:.3f} of the bound; "
          f"gradient gaps by step {tiny['gradient_gaps']}; steps off "
          f"compare_updates' bounds {tiny['steps_off_bounds']}", flush=True)
    print(f"  telemetry=True: ms/step on {[round(t, 2) for t in times['on']]}"
          f" off {[round(t, 2) for t in times['off']]} (turns off, on, on, "
          f"off); K1 {tele['k1']} and K3 {tele['k3']} launches; lists "
          f"{ {k: len(v) for k, v in lists.items()} } shapes {lists}; "
          f"app_before_comp_list[0] is the first compensation's input; "
          f"phase {report['wall_s']:.1f} s", flush=True)
    return report


# ---------------------------------------------------------------------------
# the model API over two ranks
# ---------------------------------------------------------------------------

MESH_STEPS = 2  # steps of AppMotionCompModel beside the trainer, per rank


def mesh_rank(rank, world, port, work, seed):
    """One rank of model_api_mesh (spawned; gloo, every rank on cuda:0):
    AppMotionCompModel fed the tiny global batch (NHWC numpy) beside two
    Trainers of the same seed stepped on this rank's slice, MESH_STEPS
    steps each (states and their digests, logs, K1 and K3 launches of the
    model's step); then test(), the model's EMA forward on its slice, the
    slice fed, and the error of an uneven global batch. Writes
    <work>/rank<r>.pt."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.model_api import (
        AppMotionCompModel,
    )
    from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa
    from synergize_motion_appearance_tpu_torch.parallel import (
        init_distributed, shard_batch,
    )
    from synergize_motion_appearance_tpu_torch.training import (
        Trainer, batch_to_device, step_generator,
    )

    device = "cuda:0"
    torch.cuda.set_device(device)
    init_distributed("pytorch", backend="gloo", device=device,
                     environ=rank_env(rank, world, port))
    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 0  # D and the probe at step 2
    cfg["manual_seed"] = seed
    model = AppMotionCompModel(cfg, device=device)
    trainers = [Trainer(cfg, device=device, seed=model.seed)
                for _ in range(2)]
    glob = {k: v.permute(0, 2, 3, 1).numpy() for k, v in smooth_train_batch(
        torch, 64, seed + 70, n=DP_GLOBAL_TINY).items()}
    shard = shard_batch(batch_to_device(glob, device))
    out = {"steps": []}
    for i in range(MESH_STEPS):
        model.feed_data(glob)
        fa.reset_launches()
        k3.reset_launches()
        model.optimize_parameters(i)
        launches = (fa.launches, k3.launches)
        logs = [{k: float(v) for k, v in tr.train_step(
            shard, generator=step_generator(model.seed, i, device)).items()}
            for tr in trainers]
        out["steps"].append({
            "model_digest": state_digest(torch, model.trainer),
            "trainer_digest": state_digest(torch, trainers[0]),
            "repeat_digest": state_digest(torch, trainers[1]),
            "model_state": train_state(model.trainer),
            "trainer_state": train_state(trainers[0]),
            "repeat_state": train_state(trainers[1]),
            "model_logs": dict(model.get_current_log()),
            "trainer_logs": logs[0], "repeat_logs": logs[1],
            "k1_launches": launches[0], "k3_launches": launches[1]})
    out["test"] = model.test().cpu()
    out["own_ema"] = model.trainer.ema_forward(shard["source"],
                                               shard["driving"]).cpu()
    out["fed"] = {k: v.cpu() for k, v in model.batch.items()}
    out["global"] = glob
    try:
        model.feed_data({k: v[:3] for k, v in glob.items()})
    except ValueError as e:
        out["uneven"] = str(e)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def model_api_mesh(torch, configs, seed, card):
    """Two ranks over gloo, both on cuda:0, as dp_two_ranks runs them on
    one card: AppMotionCompModel takes the global batch and keeps each
    rank's slice; its optimize_parameters is Trainer.train_step on that
    slice; test() gives the global batch on both ranks, the two slices'
    EMA forwards in rank order; a global batch of 3 raises. The ranks'
    model states are bit-identical after every step. Against the
    trainer: the card's train step does not repeat itself bit for bit
    (the backward of the grid sampler and of bilinear resizing add with
    atomics), so a second trainer stepped on the same slice measures the
    card's own gap, and the model lies no further from the first trainer
    than that (largest difference at most 3 times, share within 1e-6 at
    most 0.05 lower, as dp_world1 holds a world of one), and the first
    step's logs, computed before any update, are equal; where the second
    trainer repeats the first bit for bit, so must the model. (A later
    step's logs may part further: a nearest-codebook pick of the motion
    reconstruction can go either way once the weights differ in their
    last bits; on an H100, l_g_motion_codebook_recon moved by 8.2e-3 at
    the second step, PERF.md §6, PR 12.) The CPU test holds the model to
    the trainer bit for bit."""
    work = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        run_ranks(mesh_rank, 2, (free_port(), work, seed), RANK_TIMEOUT)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    k1_per = k1_per_train_step(configs.get("tiny_train")["network_g"])
    gaps = []
    for r, res in enumerate(ranks):
        for i, st in enumerate(res["steps"]):
            worst, close = state_gap(torch, st["model_state"],
                                     st["trainer_state"])
            noise_worst, noise_close = state_gap(
                torch, st["repeat_state"], st["trainer_state"])
            gaps.append({"rank": r, "step": i + 1, "worst": worst,
                         "share_within_1e6": close,
                         "repeat_worst": noise_worst,
                         "repeat_share_within_1e6": noise_close,
                         "bit_identical":
                             st["model_digest"] == st["trainer_digest"],
                         "repeat_bit_identical":
                             st["repeat_digest"] == st["trainer_digest"]})
            assert worst <= 3 * noise_worst and \
                close >= noise_close - 0.05, gaps[-1]
            gaps[-1]["log_diffs"] = {
                side: max(abs(st[side][k] - v) / (abs(v) + 1e-6)
                          for k, v in st["trainer_logs"].items())
                for side in ("model_logs", "repeat_logs")}
            if i == 0:  # before any update: one state, one forward
                assert st["model_logs"] == st["trainer_logs"], (r, i)
            for v in st["model_logs"].values():
                assert math.isfinite(v), (r, i, st["model_logs"])
            assert st["k1_launches"] == k1_per and st["k3_launches"] > 0, st
        glob = res["global"]
        for k in ("source", "driving"):
            want = torch.from_numpy(glob[k][2 * r:2 * r + 2]).permute(
                0, 3, 1, 2)
            assert torch.equal(res["fed"][k], want), (r, k)
        assert "does not split evenly across 2 ranks" in res["uneven"], res
    assert ranks[0]["steps"][1]["model_logs"]["d_weight"] > 0
    for a, b in zip(*(r["steps"] for r in ranks)):
        assert a["model_digest"] == b["model_digest"], "ranks part"
    want = torch.cat([r["own_ema"] for r in ranks])
    for res in ranks:
        assert res["test"].shape == (DP_GLOBAL_TINY, 3, 64, 64)
        assert torch.equal(res["test"], want), "test() is not the global batch"
    report = {"backend": "gloo", "where": "both ranks on cuda:0",
              "steps": MESH_STEPS, "global_batch": DP_GLOBAL_TINY,
              "gaps": gaps, "k1_launches_per_step": k1_per,
              "k3_launches_per_step": ranks[0]["steps"][0]["k3_launches"],
              "digests": [[st["model_digest"] for st in r["steps"]]
                          for r in ranks],
              "spawn_and_run_s": wall}
    print(f"model_api_mesh: two ranks over gloo on cuda:0 ({card}), tiny "
          f"f32, global batch {DP_GLOBAL_TINY} fed to AppMotionCompModel "
          f"on both ranks: each rank keeps its slice; {MESH_STEPS} "
          f"optimize_parameters steps against Trainer.train_step on the "
          f"slice, and a second trainer against the first (the card's own "
          f"gap): {[(g['step'], round(g['worst'], 9), round(g['share_within_1e6'], 6), round(g['repeat_worst'], 9), round(g['repeat_share_within_1e6'], 6), g['bit_identical'], g['repeat_bit_identical']) for g in gaps]} "
          f"(step, worst, share within 1e-6, repeat's worst, repeat's "
          f"share, bit-identical, repeat bit-identical); largest relative "
          f"log difference from the first trainer, model and repeat: "
          f"{[(g['step'], g['log_diffs']) for g in gaps]}; the first "
          f"step's logs equal; the ranks' model "
          f"states bit-identical; K1 {k1_per} and K3 "
          f"{report['k3_launches_per_step']} launches a step; test() the "
          f"global batch on both ranks; a batch of 3 raises; {wall:.1f} s",
          flush=True)
    return report


# ---------------------------------------------------------------------------
# the blocks off the main path: DCN, StyleGAN ops, SPADE, KPHourglass,
# flow_warp, each on the card against the CPU
# ---------------------------------------------------------------------------

BLOCK_REL = 1e-4  # card vs CPU, f32 without TF32: relative max error
BLOCK_ITERS = 10  # timed calls of each block, after 2 warm-up calls


def _block_cases(torch, seed):
    """name -> (module or function, CPU inputs, what it stands for): the
    cases of the blocks phase, seeded, on the CPU."""
    from synergize_motion_appearance_tpu_torch.models import (
        arch_util, extended_blocks,
    )
    from synergize_motion_appearance_tpu_torch.ops import (
        fused_leaky_relu, make_resample_kernel, upfirdn2d,
    )

    g = torch.Generator().manual_seed(seed + 80)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    def offsets_live(pack):
        """conv_offset starts at 0 (offsets 0, mask 0.5): draw it so the
        offsets are a few pixels and the mask varies."""
        with torch.no_grad():
            w = pack.conv_offset.weight
            w.copy_(randn(*w.shape, scale=2.0 / math.sqrt(w[0].numel())))
        return pack

    torch.manual_seed(seed + 81)
    dcn = offsets_live(arch_util.DCNv2Pack(64, 64, deformable_groups=8))
    mdcn = offsets_live(arch_util.ModulatedDeformConvPack(
        64, 64, deformable_groups=8))
    kernel = make_resample_kernel([1, 3, 3, 1])
    x64 = randn(4, 64, 64, 64)
    x256 = randn(2, 64, 256, 256)
    cases = {
        "DCNv2Pack": (dcn, (x64, randn(4, 64, 64, 64)),
                      "EDVR alignment: 64 channels, deformable_groups 8, "
                      "64x64, batch 4"),
        "ModulatedDeformConvPack": (mdcn, (x64,),
                                    "the same widths, offsets from x"),
        "upfirdn2d_up2": (lambda x: upfirdn2d(x, kernel.to(x.device), up=2,
                                              pad=(2, 1)), (x256,),
                          "StyleGAN2 upsampling: [1, 3, 3, 1], up 2, "
                          "256^2, 64 channels, batch 2"),
        "upfirdn2d_down2": (lambda x: upfirdn2d(x, kernel.to(x.device),
                                                down=2, pad=(1, 1)), (x256,),
                            "StyleGAN2 downsampling: [1, 3, 3, 1], down 2"),
        "fused_leaky_relu": (fused_leaky_relu, (x256, randn(64)),
                             "bias + leaky ReLU * sqrt(2), 64 x 256^2, "
                             "batch 2"),
        "SPADEResnetBlock": (extended_blocks.SPADEResnetBlock(64, 32, 3),
                             (randn(4, 64, 128, 128),
                              randn(4, 3, 256, 256)),
                             "64 -> 32 channels (learned shortcut), "
                             "128x128, segmap 3 x 256^2, batch 4"),
        "KPHourglass": (extended_blocks.KPHourglass(
            32, 3, reshape_features=16384, reshape_depth=16, num_blocks=5,
            max_features=1024).eval(), (randn(2, 3, 64, 64),),
            "face-vid2vid's keypoint hourglass: block_expansion 32, "
            "max_features 1024, 16384 channels as a depth-16 volume, 5 "
            "blocks, 64x64 input, batch 2, eval mode"),
        "flow_warp": (arch_util.flow_warp, (x256[:, :, :, :],
                                            randn(2, 256, 256, 2,
                                                  scale=3.0)),
                      "64 x 256^2 by a flow of ~3 px, bilinear, zeros"),
    }
    return cases


def blocks(torch, fa, k3, seed, card):
    """Each case of _block_cases on the card against the CPU on the same
    weights and inputs (within BLOCK_REL relative), with its median ms
    over BLOCK_ITERS calls (CUDA events; the host's share included) and
    its peak memory; no K1-K4 launch (none of these reaches a TPU kernel
    in the JAX package)."""
    t_phase = time.perf_counter()
    report = {}
    fa.reset_launches()
    k3.reset_launches()
    for name, (fn, args, what) in _block_cases(torch, seed).items():
        with torch.no_grad():
            want = fn(*args)
            card_fn = (fn.to("cuda") if isinstance(fn, torch.nn.Module)
                       else fn)
            card_args = [a.to("cuda") for a in args]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = card_fn(*card_args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            err = max_rel(torch, got, want)
            ms = time_ms(torch, lambda: card_fn(*card_args), BLOCK_ITERS)
        assert tuple(got.shape) == tuple(want.shape), (name, got.shape)
        assert err <= BLOCK_REL, (name, err)
        report[name] = {"what": what, "max_rel_err": err, "ms": ms,
                        "peak_bytes_above_inputs": peak,
                        "out_shape": list(got.shape)}
        print(f"blocks: {name} ({what}): card vs CPU max rel err {err:.3e}, "
              f"{ms:.3f} ms (median of {BLOCK_ITERS}, CUDA events), peak "
              f"{peak / 2 ** 20:.1f} MiB above its inputs", flush=True)
        del got, want, card_fn, card_args
        torch.cuda.empty_cache()
    launches = samt_launches(fa, k3)
    assert not any(launches.values()), launches
    report["launches"] = launches
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"blocks: no K1-K4 launch; phase {report['wall_s']:.1f} s on "
          f"{card}", flush=True)
    return report


# ---------------------------------------------------------------------------
# data and utils: the modules of the JAX package's data/ and utils/
# ---------------------------------------------------------------------------

DATA_MODULES = ("utils.env", "utils.misc", "utils.file_client",
                "utils.matlab_functions", "data.data_util",
                "data.augmentation", "utils.img_util",
                "utils.tiled_inference", "utils.video_util",
                "utils.profiler", "utils.lmdb_util")
OPTIONAL_PACKAGES = ("cv2", "PIL", "imageio", "yaml", "lmdb")
DUF_SHAPE = (2, 7, 256, 256, 3)   # (B, T, H, W, C) of duf_downsample, x4
GRAD_SHAPE = (FRAME_BATCH, 256, 256, 3)  # grad_layer's frame batch
TILED_SIZE, TILE, TILE_PAD = 512, 128, 10  # TiledRestorer over grad_layer
DATA_REL = 1e-5  # card vs CPU, f32 without TF32: relative max error
TRACE_RANGE = "frame_batch"  # the annotated range of the profiled batch


def traced_k1(trace_path):
    """From a Chrome trace of torch.profiler: the K1 kernels launched inside
    the CPU range TRACE_RANGE (the runtime or driver call with the kernel's
    correlation id lies inside it), the number of device events, and the
    device time (kernels, copies and memsets) in ms."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == TRACE_RANGE
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 1, f"{len(ranges)} {TRACE_RANGE} ranges"
    (start, end), = ranges
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    k1 = [e for e in device if e["cat"] == "kernel"
          and "attn_packed_kernel" in e["name"]
          and start <= launched.get(e["args"].get("correlation"), -1) <= end]
    return len(k1), len(device), sum(e["dur"] for e in device) / 1e3


def data_utils(torch, configs, ReenactmentPipeline, seeded_nets, fa, k3,
               seed, card):
    """The slice of the JAX package's data/ and utils/: every module
    imported on this machine (OPTIONAL_PACKAGES that it lacks are
    reported); one flagship frame batch of the main path profiled with
    utils.profiler.trace and annotate (K1's 32 launches inside the
    annotated range of the Chrome trace, equal to the launch counter) and
    timed by StepTimer; duf_downsample and grad_layer on the card against
    the CPU; TiledRestorer over grad_layer on the card, tiles against the
    whole pass bit for bit."""
    import importlib
    import importlib.util

    t_phase = time.perf_counter()
    for name in DATA_MODULES:
        importlib.import_module(f"synergize_motion_appearance_tpu_torch."
                                f"{name}")
    absent = [p for p in OPTIONAL_PACKAGES
              if importlib.util.find_spec(p) is None]
    print(f"data_utils: imported {len(DATA_MODULES)} modules; absent on "
          f"this machine: {absent}", flush=True)
    from synergize_motion_appearance_tpu_torch.data.data_util import (
        duf_downsample,
    )
    from synergize_motion_appearance_tpu_torch.utils import profiler
    from synergize_motion_appearance_tpu_torch.utils.img_util import (
        grad_layer,
    )
    from synergize_motion_appearance_tpu_torch.utils.tiled_inference import (
        TiledRestorer,
    )
    report = {"modules": list(DATA_MODULES), "absent_packages": absent}

    # one frame batch of the main path under the profiler
    g, me = seeded_nets(configs.get("flagship_256"), seed)
    pipe = ReenactmentPipeline(g, me, relative=True, adapt_scale=True,
                               frame_batch=FRAME_BATCH,
                               compute_dtype=torch.bfloat16, u8_io=True,
                               device="cuda")
    src = frames(1, 256, seed + 20)
    drv = frames(FRAME_BATCH, 256, seed + 21)
    pipe.animate(src, drv)  # warm-up: first-call setup stays out
    logdir = os.path.join(ROOT, "build", "chip_smoke_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    timer = profiler.StepTimer()
    try:
        for _ in range(3):  # a session that records no device activity reruns
            fa.reset_launches()
            k3.reset_launches()
            timer.mark_data()
            with profiler.trace(logdir):
                with profiler.annotate(TRACE_RANGE):
                    out = pipe.animate(src, drv)
                timer.mark_step(block_on=next(pipe.net_g.parameters()))
            launches = samt_launches(fa, k3)
            trace_path = max(
                (os.path.join(logdir, n) for n in os.listdir(logdir)),
                key=os.path.getmtime)
            k1_traced, n_device, device_ms = traced_k1(trace_path)
            if n_device:
                break
        trace_bytes = os.path.getsize(trace_path)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    assert n_device, "the profiler saw no device activity in 3 sessions"
    assert out.shape == (FRAME_BATCH, 256, 256, 3) and out.std() > 0
    assert launches == {"k1": 32, "k2": 0, "k3": 0, "k4": 0}, launches
    assert k1_traced == launches["k1"], (k1_traced, launches)
    step_ms = 1e3 * timer.step_time
    report.update(k1_launches=launches["k1"], k3_launches=launches["k3"],
                  k1_in_trace=k1_traced, trace_device_events=n_device,
                  trace_device_ms=device_ms, step_timer_ms=step_ms,
                  trace_bytes=trace_bytes)
    print(f"data_utils: profiler.trace of one frame batch of {FRAME_BATCH}: "
          f"{k1_traced} K1 kernels launched inside annotate("
          f"{TRACE_RANGE!r}) (launch counter {launches['k1']}), "
          f"{n_device} device events, device {device_ms:.2f} ms; StepTimer "
          f"step {step_ms:.2f} ms (under the profiler); Chrome trace "
          f"{trace_bytes / 2 ** 20:.1f} MiB", flush=True)
    del pipe, g, me
    torch.cuda.empty_cache()

    # duf_downsample and grad_layer, card against CPU
    gen = torch.Generator().manual_seed(seed + 70)
    for name, fn, shape in (
            ("duf_downsample", lambda x: duf_downsample(x, scale=4),
             DUF_SHAPE),
            ("grad_layer", grad_layer, GRAD_SHAPE)):
        x = torch.rand(shape, generator=gen)
        want = fn(x)
        x_card = x.cuda()
        got = fn(x_card)
        err = max_rel(torch, got, want)
        ms = time_ms(torch, lambda: fn(x_card), BLOCK_ITERS)
        assert tuple(got.shape) == tuple(want.shape), (name, got.shape)
        assert got.device.type == "cuda", name
        assert err <= DATA_REL, (name, err)
        report[name] = {"shape": list(shape), "out_shape": list(got.shape),
                        "max_rel_err": err, "ms": ms}
        print(f"data_utils: {name} {list(shape)} -> {list(got.shape)}: card "
              f"vs CPU max rel err {err:.3e}, {ms:.3f} ms (median of "
              f"{BLOCK_ITERS}, CUDA events)", flush=True)

    # TiledRestorer over grad_layer on the card: tiles equal the whole pass
    img = np.random.RandomState(seed + 71).rand(
        1, TILED_SIZE, TILED_SIZE, 3).astype(np.float32)
    t0 = time.perf_counter()
    whole = TiledRestorer(grad_layer, device="cuda").enhance(img)
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiled = TiledRestorer(grad_layer, tile_size=TILE, tile_pad=TILE_PAD,
                          device="cuda").enhance(img)
    tiled_s = time.perf_counter() - t0
    cpu = TiledRestorer(grad_layer, device="cpu").enhance(img)
    assert tiled.shape == whole.shape == (1, TILED_SIZE, TILED_SIZE, 1)
    assert np.array_equal(tiled, whole), float(np.abs(tiled - whole).max())
    cpu_err = float(np.abs(whole - cpu).max() / np.abs(cpu).max())
    assert cpu_err <= DATA_REL, cpu_err
    report["tiled"] = {"size": TILED_SIZE, "tile": TILE, "pad": TILE_PAD,
                       "tiles": (TILED_SIZE // TILE) ** 2,
                       "equal_to_whole": True, "max_rel_err_cpu": cpu_err,
                       "whole_s": whole_s, "tiled_s": tiled_s}
    print(f"data_utils: TiledRestorer(grad_layer) {TILED_SIZE}^2, tile "
          f"{TILE} pad {TILE_PAD}: {(TILED_SIZE // TILE) ** 2} tiles equal "
          f"the whole pass bit for bit ({tiled_s:.3f} s against "
          f"{whole_s:.3f} s, host stitching included); whole vs CPU max rel "
          f"err {cpu_err:.3e}", flush=True)
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"data_utils: phase {report['wall_s']:.1f} s on {card}",
          flush=True)
    return report


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def serving_two_device(torch, configs, ReenactmentPipeline, seeded_nets,
                       serving, fa, live, src, drv, work, seed, card,
                       per_batch):
    """A two-device artifact (platforms=("cpu", "cuda")) of the main
    path's pipeline ``live``: the card's programs hold per_batch samt ops
    in gen and give frames within 1 level of the live card pipeline's,
    launching K1 per_batch times a frame batch (counts set to 0 just
    before, read just after); the CPU's programs hold no samt op; one
    params.pt. Then a tiny f32 two-device artifact exported on the card
    whose CPU programs, loaded with device "cpu", give frames within 1
    level of the live CPU pipeline's on the same weights. Returns the
    report; the artifacts are left in ``work`` for serving_path to
    remove."""
    size = live.img_size
    art = os.path.join(work, "two_device")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serving.export_pipeline(live, art, platforms=("cpu", "cuda"))
    export_s = time.perf_counter() - t0
    assert sorted(os.listdir(art)) == ["cpu", "cuda", "manifest.json",
                                       "params.pt"], os.listdir(art)
    ops = {}
    for dev in ("cpu", "cuda"):
        for stage in serving._STAGES:
            targets, state = graph_targets(
                torch, os.path.join(art, dev, f"{stage}.pt2"))
            assert not state, f"{dev}/{stage}.pt2 holds {len(state)} weights"
            assert not any("scaled_dot_product" in t for t in targets)
            ops[f"{dev}/{stage}"] = sum("samt." in t for t in targets)
    assert ops == {"cpu/kp1": 0, "cpu/kpN": 0, "cpu/enc": 0, "cpu/gen": 0,
                   "cuda/kp1": 0, "cuda/kpN": 0, "cuda/enc": 0,
                   "cuda/gen": per_batch}, ops
    served = serving.load_serving_pipeline(art)
    assert served.device.type == "cuda"
    fa.reset_launches()
    out = served.animate(src, drv)
    launches = fa.launches
    n_batches = math.ceil(len(drv) / FRAME_BATCH)
    assert launches == per_batch * n_batches, (launches, per_batch)
    want = live.animate(src, drv)
    diff = np.abs(out.astype(np.int32) - want.astype(np.int32))
    assert out.shape == want.shape and diff.max() <= 1, diff.max()

    cfg = configs.get("tiny")
    kw = dict(relative=True, adapt_scale=True, frame_batch=4,
              compute_dtype=torch.float32, u8_io=True)
    tiny_art = os.path.join(work, "two_device_tiny")
    serving.export_pipeline(ReenactmentPipeline(*seeded_nets(cfg, seed),
                                                device="cuda", **kw),
                            tiny_art, platforms=("cpu", "cuda"))
    cpu_live = ReenactmentPipeline(*seeded_nets(cfg, seed), device="cpu",
                                   **kw)
    cpu_served = serving.load_serving_pipeline(tiny_art, "cpu")
    t_src, t_drv = frames(1, 64, seed + 42), frames(6, 64, seed + 43)
    fa.reset_launches()
    cpu_out = cpu_served.animate(t_src, t_drv)
    assert fa.launches == 0
    cpu_diff = np.abs(cpu_out.astype(np.int32)
                      - cpu_live.animate(t_src, t_drv).astype(np.int32))
    assert cpu_diff.max() <= 1, cpu_diff.max()
    card_served = serving.load_serving_pipeline(tiny_art)
    card_diff = np.abs(card_served.animate(t_src, t_drv).astype(np.int32)
                       - cpu_out.astype(np.int32))
    report = {"export_s": export_s, "bytes": dir_bytes(art),
              "stage_ops": ops, "k1_launches_card": launches,
              "max_diff_levels_card": int(diff.max()),
              "identical_share_card": float((diff == 0).mean()),
              "k1_launches_cpu": 0,
              "max_diff_levels_cpu_tiny": int(cpu_diff.max()),
              "identical_share_cpu_tiny": float((cpu_diff == 0).mean()),
              "tiny_card_vs_cpu_programs_max_levels": int(card_diff.max())}
    print(f"serving: two-device artifact (cpu, cuda) of flagship-{size} "
          f"bf16 uint8: {report['bytes']} bytes, export {export_s:.2f} s; "
          f"samt ops by program {ops}; card programs vs the live card "
          f"pipeline over {len(drv)} frames: max |diff| {diff.max()} levels "
          f"(identical share {report['identical_share_card']:.6f}), K1 "
          f"{launches} launches; tiny f32 CPU programs vs the live CPU "
          f"pipeline: max |diff| {cpu_diff.max()} levels, no K1 launch "
          f"(its card programs vs its CPU programs: {card_diff.max()} "
          f"levels) on {card}", flush=True)
    return report


# the kernels-line entries of the TIMED_WIDTHS shapes: (name, source, the
# width timed, where the launches come from)
TIMED_ENTRIES = [
    ("fused_attention_packed (wgmma d = 96)", "fused_attention_wgmma128.cu",
     96, ("frame_batch_app_d96", "wgmma128")),
    ("fused_attention_packed (wgmma d = 192)", "fused_attention_wgmma256.cu",
     192, None),
    ("fused_attention_packed (f32 wide d = 320)",
     "fused_attention_chunked.cu", 320, ("tiny_d320", "f32wide")),
    ("fused_attention_packed (wgmma d = 384)", "fused_attention_wgmma512.cu",
     384, ("frame_batch_app_d384", "wgmma512")),
    ("fused_attention_packed (f32 wide d = 640)",
     "fused_attention_chunked.cu", 640, ("tiny_d640", "f32wide")),
]


def widths_note(rows):
    """The dtypes and head widths of ``rows``, as "bfloat16 d = 161 and
    320, float32 d = 512"."""
    by = {}
    for r in rows:
        by.setdefault(r["dtype"], set()).add(r["d"])
    notes = []
    for dtype, ds in sorted(by.items()):
        ds = [str(d) for d in sorted(ds)]
        listed = ", ".join(ds[:-1]) + " and " + ds[-1] if len(ds) > 1 \
            else ds[0]
        notes.append(f"{dtype} d = {listed}")
    return ", ".join(notes)


def width_kernel_entries(widths):
    """The kernels-line entries of the kernels that only the
    attention_widths phase (``widths``, its report) runs on the card: the
    d-chunked kernels, the float32 wide kernel, the d = 1 kernel, the
    d = 128 and d = 256 wgmma kernels, and the instantiations timed at
    TIMED_WIDTHS (TIMED_ENTRIES)."""
    def width_rows(layout, kernel):
        return [r for rows in widths[layout].values() for r in rows
                if r["kernel"] == kernel]

    def ragged(kernel):
        return widths_note(r for r in widths["k1"]["ragged"]
                           if r["kernel"] == kernel)

    def timed_entry(name, source, d, launched):
        rows = [r for r in widths["timed"] if r["d"] == d]
        return kernel_entry(
            name, source, "fused_attention.py:227", rows, "calls",
            widths[launched[0]]["k1_kernels"][launched[1]] if launched
            else 0,
            f"one call at {rows[0]['case']} ({rows[0]['dtype']}, B "
            f"{rows[0]['B']}, L = K = {rows[0]['L']}, H {rows[0]['H']}, "
            f"bias on: one appearance launch of a flagship frame batch at "
            f"that width; attention_widths phase) on plan's kernel "
            f"({rows[0]['kernel']}); device_ms the mean of its two turns "
            f"beside the d-chunked kernel forced through plan "
            f"(chunked_device_ms), device_ms_k2 K2 at the same shape; "
            f"library_device_ms and the bound as for K1",
            summed=lambda r: True,
            launches_note=(f"{launched[1]} launches in the {launched[0]} "
                           f"run of the attention_widths phase" if launched
                           else "no frame batch of the phase runs this "
                           "width; 0 on every shipped config"),
            **{key: rows[0][key] for key in (
                "device_ms_turns", "chunked_device_ms",
                "chunked_over_kernel", "device_ms_k2",
                "max_abs_err_chunked", "max_abs_err_k2", "bound_share")})

    return [
        kernel_entry(
            "fused_attention_packed (d-chunked)",
            "fused_attention_chunked.cu", "fused_attention.py:227",
            width_rows("k1", "chunked"), "calls",
            sum(row["k1_kernels"].get("chunked", 0)
                for row in widths["frame_batches"].values()),
            f"sum over one call at each ragged shape it takes in the "
            f"attention_widths phase ({ragged('chunked')}; "
            f"chiprun_out/chip_smoke.json has each); device_ms, "
            f"library_device_ms and the bound as for K1",
            summed=lambda r: "device_ms" in r,
            launches_note="launches over the three frame batches of the "
                          "attention_widths phase (n_head 1, 2, 32): "
                          "none takes its widths (bf16 above 64 where the "
                          "wgmma kernels do not run, float32 above 1024); "
                          "0 on every shipped config (n_head 8)",
            max_abs_err_k2=max(r["max_abs_err"]
                               for r in width_rows("k2", "chunked"))),
        kernel_entry(
            "fused_attention_packed (f32 wide)",
            "fused_attention_chunked.cu", "fused_attention.py:227",
            width_rows("k1", "f32wide"), "launches_per_frame_batch",
            widths["frame_batch_float32"]["k1_kernels"]["f32wide"],
            f"sum over the appearance transformer's 16 float32 launches "
            f"(d = 256) of one flagship frame batch at n_head 1 "
            f"(attention_widths phase), on attn_packed_kernel_f32wide<256>; "
            f"the d = 128 ones at n_head 2 (<128>) in the _d128 keys, K2 "
            f"at the same shapes in the _k2 keys; the ragged "
            f"{ragged('f32wide')} cases are checked, not summed; device_ms, "
            f"library_device_ms and the bound as for K1",
            summed=lambda r: r["d"] == 256,
            launches_note="launches in the float32 frame batch at n_head 1 "
                          "of the attention_widths phase; 0 on every "
                          "shipped config (n_head 8) and on the bf16 paths",
            **{f"{key}_{suffix}": widths["halves"][H][layout][
                f"appearance_float32_d{256 // int(H)}_f32wide"][key]
               for H, layout, suffix in (("2", "k1", "d128"),
                                         ("1", "k2", "k2"),
                                         ("2", "k2", "k2_d128"))
               for key in ("device_ms", "library_device_ms", "bound_ms",
                           "bound_share")},
            max_abs_err_k2=max(r["max_abs_err"]
                               for r in width_rows("k2", "f32wide"))),
        kernel_entry(
            "fused_attention_packed (d = 1)",
            "fused_attention_chunked.cu", "fused_attention.py:227",
            width_rows("k1", "d1"), "launches_per_frame_batch",
            widths["frame_batches"]["32"]["k1_kernels"]["d1"],
            "sum over the motion transformer's 16 float32 launches (d = 1) "
            "of one flagship frame batch at n_head 32 (attention_widths "
            "phase), on attn_packed_kernel_chunked_f32<1, 1, float>; the "
            "same shapes in bfloat16 (<1, 1, bf16>, on no path) in the "
            "_bf16 keys, K2's in the _k2 keys; device_ms, "
            "library_device_ms and the bound as for K1",
            summed=lambda r: r["on_path"],
            launches_note="launches over the three frame batches of the "
                          "attention_widths phase (n_head 1, 2, 32); 0 on "
                          "every shipped config (n_head 8)",
            **{f"{key}_{suffix}": widths["halves"]["32"][layout][
                f"motion_{dtype}_d1_d1"][key]
               for layout, dtype, suffix in (
                   ("k1", "bfloat16", "bf16"), ("k2", "float32", "k2"),
                   ("k2", "bfloat16", "bf16_k2"))
               for key in ("device_ms", "library_device_ms", "bound_ms",
                           "bound_share")},
            max_abs_err_k2=max(r["max_abs_err"]
                               for r in width_rows("k2", "d1"))),
        *(kernel_entry(
            f"fused_attention_packed (wgmma d = {d})",
            f"fused_attention_wgmma{d}.cu", "fused_attention.py:227",
            width_rows("k1", f"wgmma{d}"), "launches_per_frame_batch",
            sum(row["k1_kernels"].get(f"wgmma{d}", 0)
                for row in widths["frame_batches"].values()),
            f"sum over the appearance transformer's 16 bf16 launches (d = "
            f"{d}) of one flagship frame batch at n_head {256 // d} "
            f"(attention_widths phase), on "
            f"attn_packed_kernel_wgmma{d}<{d}, false, BIAS>; the ragged "
            f"{ragged(f'wgmma{d}')} cases (with TIMED_WIDTHS, every "
            f"instantiation of the design) are checked, not summed; "
            f"device_ms, "
            f"library_device_ms and the bound as for K1, device_ms_k2 K2 at "
            f"the same shapes",
            summed=lambda r: r["on_path"],
            launches_note="launches over the three frame batches of the "
                          "attention_widths phase (n_head 1, 2, 32); 0 on "
                          "every shipped config (n_head 8)",
            device_ms_k2=sum(
                r["device_ms"] * r["k1_launches_per_frame_batch"]
                for r in widths["k2"][str(256 // d)]
                if r["kernel"] == f"wgmma{d}" and "device_ms" in r),
            max_abs_err_k2=max(
                r["max_abs_err"] for rows in widths["k2"].values()
                for r in rows if r["kernel"] == f"wgmma{d}"))
          for d in (128, 256)),
        *(timed_entry(*entry) for entry in TIMED_ENTRIES),
    ]


def kernel_entry(name, source, replaces, rows, weight, launches,
                 times_are, summed=None, **extra):
    """One kernel's entry of the kernels line: errors over its bf16 cases
    (max_abs_err; its float32 ones for a float32-only kernel) and float32
    cases; times and bound summed over the cases ``summed`` picks (by
    default its bf16 cases), each weighted by ``weight`` (its launches in
    one unit of the path; the ragged cases, weighted 0, are checked and
    not timed)."""
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    f32 = [r for r in rows if r["dtype"] == "float32"]
    timed = [r for r in (bf16 if summed is None else filter(summed, rows))
             if r[weight]]

    def total(key):
        return sum(r[key] * r[weight] for r in timed)

    if timed and all("device_ms" in r for r in timed):
        extra.update(device_ms=total("device_ms"),
                     library_device_ms=total("library_device_ms"))
    for key in ("mma_device_ms", "wpack_device_ms"):
        if timed and all(key in r for r in timed):
            extra[key] = total(key)
    bound = total("bound_ms")
    by_bytes = sum(r["bound_ms"] * r[weight] for r in timed
                   if r["bound_by"] == "bytes")
    return {
        "name": name, "route": "cuda",
        "source": f"synergize_motion_appearance_tpu_torch/csrc/{source}",
        "replaces": f"synergize_motion_appearance_tpu/ops/{replaces}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in bf16 or f32),
        **({"max_abs_err_f32": max(r["max_abs_err"] for r in f32)}
           if f32 and bf16 else {}),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes > bound / 2 else "operations",
        "library_ms": total("library_ms"), "times_are": times_are, **extra}


def main():
    t_start = time.perf_counter()
    args = parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.inference import (
        ReenactmentPipeline,
    )
    from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3
    from synergize_motion_appearance_tpu_torch.ops import cuda_build
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa
    from synergize_motion_appearance_tpu_torch.ops import sample_random_tps
    from synergize_motion_appearance_tpu_torch.training import Trainer
    from synergize_motion_appearance_tpu_torch.weights import seeded_nets

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    build_s = cuda_build.build("fused_attention_packed",
                               "fused_attention_wgmma",
                               "fused_attention_wgmma128",
                               "fused_attention_wgmma256",
                               "fused_attention_wgmma512",
                               "fused_attention_chunked", "conv3x3",
                               "conv3x3_wgmma")
    print(f"built fused_attention_packed, fused_attention_wgmma, "
          f"fused_attention_wgmma128, fused_attention_wgmma256, "
          f"fused_attention_wgmma512, fused_attention_chunked, conv3x3 and "
          f"conv3x3_wgmma (one nvcc each, in parallel) in {build_s:.2f} s",
          flush=True)

    report = PhaseClock(card=card, torch=torch.__version__,
                        cuda=torch.version.cuda, build_s=build_s)
    report["conv3x3_build"] = build_report(cuda_build, "conv3x3",
                                           "conv3x3_kernel",
                                           "conv3x3_kernel_tc")
    report["conv3x3_wgmma_build"] = build_report(
        cuda_build, "conv3x3_wgmma", "conv3x3_kernel",
        "conv3x3_kernel_wgmma", no_spill=("conv3x3_kernel_wgmma",),
        tc_op="HGMMA")
    # mma.sync <1, true> and <4, false>: its d = 4 and d = 32
    # instantiations; float32 <4, 4>: the motion transformer's
    report["attention_build"] = build_report(
        cuda_build, "fused_attention_packed", "attn_packed_kernel",
        "attn_packed_kernel_tc", no_spill=("ILi1ELb1E", "ILi4ELb0E",
                                           "kernelILi4ELi4E"))
    report["attention_wgmma_build"] = build_report(
        cuda_build, "fused_attention_wgmma", "attn_packed_kernel",
        "attn_packed_kernel_wgmma", no_spill=("attn_packed_kernel_wgmma",),
        tc_op="HGMMA")
    # <D, M4, BIAS>: D = 96 and 128 (d = 128 on 3-d maps, 104..120 on 4-d
    # ones); D = 160, 192, 224 and 256 (the same at 256)
    report["attention_wgmma128_build"] = build_report(
        cuda_build, "fused_attention_wgmma128", "attn_packed_kernel",
        "attn_packed_kernel_wgmma128",
        no_spill=("attn_packed_kernel_wgmma128",), tc_op="HGMMA",
        instances={"attn_packed_kernel_wgmma128": 6})
    report["attention_wgmma256_build"] = build_report(
        cuda_build, "fused_attention_wgmma256", "attn_packed_kernel",
        "attn_packed_kernel_wgmma256",
        no_spill=("attn_packed_kernel_wgmma256",),
        tc_op="HGMMA", instances={"attn_packed_kernel_wgmma256": 10})
    # <W, BIAS>: W = 160, 192, 224 and 256
    report["attention_wgmma512_build"] = build_report(
        cuda_build, "fused_attention_wgmma512", "attn_packed_kernel",
        "attn_packed_kernel_wgmma512",
        no_spill=("attn_packed_kernel_wgmma512",), tc_op="HGMMA",
        instances={"attn_packed_kernel_wgmma512": 8})
    # the wide kernel at C = 128, 256, .., 1024
    report["attention_chunked_build"] = build_report(
        cuda_build, "fused_attention_chunked", "attn_packed_kernel",
        "attn_packed_kernel_chunked_tc",
        no_spill=("attn_packed_kernel_chunked",
                  "attn_packed_kernel_f32wide"),
        instances={"attn_packed_kernel_f32wide": 8})
    rate = exp_rate(torch)
    report["exp_rate"] = rate
    print(f"exponentials: {EXP_PER_SM_CLOCK} per SM per clock x "
          f"{rate['sms']} SMs x {rate['sm_clock_max_mhz']} MHz = "
          f"{rate['exp_per_s']:.4g}/s", flush=True)
    report["k1_cases"] = check_attention(torch, fa, FRAME_BATCH, rate)
    report["k1_halves"] = attention_halves(report["k1_cases"])
    report["k2_cases"] = check_attention_split(torch, fa, FRAME_BATCH, rate)
    train_cfg = configs.get("flagship_train")
    fwd_convs = k3_forward_convs(train_cfg["network_g"])
    report["k3_cases"] = check_conv3x3(torch, k3, fwd_convs, TRAIN_BATCH)
    report["k4_cases"] = check_conv3x3_nhwc(torch, k3, fwd_convs,
                                            TRAIN_BATCH)
    report["tiny_parity"] = tiny_parity(torch, configs, ReenactmentPipeline,
                                        seeded_nets, fa, args.seed)
    report["main_path"], run = main_path(
        torch, configs, ReenactmentPipeline, seeded_nets, fa, args.seed, card)
    report["profile"] = profile_frame_batch(torch, *run, card)
    del run
    torch.cuda.empty_cache()
    report["tiny_train_parity"] = tiny_train_parity(
        torch, configs, Trainer, sample_random_tps, k3, args.seed)
    report["train_path"], train_run = train_path(
        torch, configs, Trainer, fa, k3, args.seed, card)
    report["train_profile"] = profile_train_step(torch, *train_run, card)
    del train_run
    torch.cuda.empty_cache()
    report["train_options"] = train_options(
        torch, configs, Trainer, sample_random_tps, fa, k3, args.seed, card,
        report["train_path"]["step_ms_median"])
    torch.cuda.empty_cache()
    report["ablations"] = ablations(
        torch, configs, ReenactmentPipeline, seeded_nets, Trainer,
        sample_random_tps, fa, k3, args.seed, card)
    torch.cuda.empty_cache()
    report["attention_widths"] = attention_widths_phase(args.seed, card)
    report["train_cli"] = train_cli(torch, configs, fa, k3, args.seed, card)
    torch.cuda.empty_cache()
    report["distributed"] = distributed(
        torch, configs, Trainer, ReenactmentPipeline, seeded_nets, fa, k3,
        args.seed, card)
    torch.cuda.empty_cache()
    report["model_api_mesh"] = model_api_mesh(torch, configs, args.seed, card)
    report["entry_points"] = entry_points(
        torch, configs, ReenactmentPipeline, seeded_nets, fa, args.seed, card)
    torch.cuda.empty_cache()
    report["serving"] = serving_path(
        torch, configs, ReenactmentPipeline, seeded_nets, fa, args.seed, card)
    torch.cuda.empty_cache()
    report["sr_model"] = sr_model(torch, configs, fa, k3, args.seed, card)
    sr_launches = report["sr_model"]["train"]["launches"]
    torch.cuda.empty_cache()
    report["blocks"] = blocks(torch, fa, k3, args.seed, card)
    torch.cuda.empty_cache()
    report["data_utils"] = data_utils(
        torch, configs, ReenactmentPipeline, seeded_nets, fa, k3, args.seed,
        card)
    opts = report["train_options"]
    two_device = report["serving"]["two_device"]

    cli = report["train_cli"]["fresh"]["launches"]
    k3_per_step = report["train_path"]["k3_launches_per_step"]
    dp = report["distributed"]
    ablated = report["ablations"]["variants"]
    widths = report["attention_widths"]
    kernels = [
        kernel_entry(
            "fused_attention_packed", "fused_attention_packed.cu",
            "fused_attention.py:227", report["k1_cases"],
            "launches_per_frame_batch", report["main_path"]["k1_launches"],
            f"sum over the 32 launches of one frame batch of {FRAME_BATCH} "
            f"in the pipeline's dtypes: the 16 of the motion transformer "
            f"in float32, the 16 of the appearance one in bfloat16 "
            f"(chiprun_out/chip_smoke.json has each shape; the ragged "
            f"shapes and the captured pipeline inputs are checked, not "
            f"summed); device_ms is the profiler's device time of the same "
            f"calls, without the host's share of each call that ms holds, "
            f"library_device_ms SDPA's; device_ms_bf16 the 32 launches all "
            f"in bfloat16, as measured before; device_ms_appearance and "
            f"device_ms_motion the two halves on the path (bf16 d = 32 on "
            f"the wgmma kernel of fused_attention_wgmma.cu, float32 d = 4 "
            f"on the CUDA-core kernel of fused_attention_packed.cu), each "
            f"with SDPA's, its bound and, for float32, the issue-slot "
            f"estimate; train_B2_device_ms the train step's B = 2 shapes; "
            f"device_ms_appearance_n_head_2 the appearance half's 16 bf16 "
            f"launches at n_head 2 (d = 128, on the d = 128 wgmma kernel of "
            f"fused_attention_wgmma128.cu; attention_widths phase); "
            f"the bound is the largest of bytes, FLOP and exponentials",
            summed=lambda r: r["on_path"],
            sources=[f"synergize_motion_appearance_tpu_torch/csrc/{s}" for s
                     in ("fused_attention_wgmma.cu",
                         "fused_attention_packed.cu",
                         "fused_attention_chunked.cu",
                         "fused_attention_wgmma128.cu")],
            **{f"{key}_{half}": h[key]
               for half, h in report["k1_halves"].items()
               if half != "train_B2" for key in h},
            train_B2_device_ms=report["k1_halves"]["train_B2"],
            device_ms_bf16=sum(
                r["device_ms"] * r["launches_per_frame_batch"]
                for r in report["k1_cases"]
                if r["dtype"] == "bfloat16" and "device_ms" in r),
            device_ms_appearance_n_head_2=sum(
                r["device_ms"] * r["launches_per_frame_batch"]
                for r in widths["k1"]["2"]
                if r["on_path"] and r["dtype"] == "bfloat16"),
            launches_train_path=report["train_path"]["k1_launches"],
            launches_train_cli=cli["k1"],
            launches_anchor_path=report["entry_points"]["anchor_path"][
                "k1_launches"],
            launches_test_run=report["entry_points"]["test_run"][
                "k1_launches"],
            launches_served_path=report["serving"]["k1_launches"],
            launches_dp_train=dp["two_ranks"]["k1_launches"],
            launches_frame_parallel=dp["frame_parallel"]["mesh"][
                "k1_per_frame_batch"],
            launches_ablations={
                name: {"frame_batch": row["inference"]["k1_launches"],
                       "train_step": row["train"]["k1_launches"]}
                for name, row in ablated.items()},
            launches_sr_model=sr_launches["k1"],
            launches_train_options=opts["k1_launches"],
            launches_train_telemetry=opts["telemetry"]["k1_launches"],
            launches_model_api_mesh=report["model_api_mesh"][
                "k1_launches_per_step"],
            launches_served_two_device_cuda=two_device["k1_launches_card"],
            launches_served_two_device_cpu=two_device["k1_launches_cpu"],
            launches_blocks=report["blocks"]["launches"]["k1"],
            launches_data_utils=report["data_utils"]["k1_launches"],
            launches_head_widths={
                f"n_head_{H}": row["k1_kernels"]
                for H, row in widths["frame_batches"].items()}),
        kernel_entry(
            "fused_attention (head-split)", "fused_attention_packed.cu",
            "fused_attention.py:56", report["k2_cases"],
            "k1_launches_per_frame_batch",
            report["main_path"]["k2_launches"],
            "sum over K1's 32 launches of one frame batch, relaid to "
            "(B, H, L, d), bf16; the ragged-K case is checked, not summed; "
            "device_ms, library_device_ms and the bound as for K1",
            sources=[f"synergize_motion_appearance_tpu_torch/csrc/{s}" for s
                     in ("fused_attention_wgmma.cu",
                         "fused_attention_packed.cu")],
            launches_note="no path calls it, in the port or the JAX "
                          "package: 0 launches on the inference path, the "
                          "train step and the train CLI",
            launches_train_path=report["train_path"]["k2_launches"],
            launches_train_cli=cli["k2"]),
        *width_kernel_entries(widths),
        kernel_entry(
            "conv3x3", "conv3x3_wgmma.cu", "pallas_conv_wl.py:39",
            report["k3_cases"], "launches_per_step",
            report["train_path"]["k3_launches"],
            f"sum over the {k3_per_step} bf16 launches (forward and input "
            f"gradient) of one flagship train step at batch {TRAIN_BATCH} "
            f"(chiprun_out/chip_smoke.json has each shape; the ragged "
            f"shapes are checked, not summed), all on the wgmma kernel of "
            f"conv3x3_wgmma.cu; device_ms is the profiler's device time of "
            f"the same calls, without the host's share of each call that "
            f"ms holds, wpack_device_ms the weight-packing launches' part "
            f"of it, mma_device_ms the mma.sync kernel of conv3x3.cu (the "
            f"ragged bf16 shapes' kernel) on the same inputs, "
            f"library_device_ms the library's",
            sources=[f"synergize_motion_appearance_tpu_torch/csrc/{s}" for s
                     in ("conv3x3_wgmma.cu", "conv3x3.cu")],
            launches_train_cli=cli["k3"],
            launches_dp_train=dp["two_ranks"]["k3_launches"],
            launches_ablations={name: row["train"]["k3_launches"]
                                for name, row in ablated.items()},
            launches_sr_model=sr_launches["k3"],
            launches_train_options=opts["k3_launches"],
            launches_train_telemetry=opts["telemetry"]["k3_launches"],
            launches_model_api_mesh=report["model_api_mesh"][
                "k3_launches_per_step"],
            launches_blocks=report["blocks"]["launches"]["k3"],
            launches_data_utils=report["data_utils"]["k3_launches"],
            launches_note="launches_dp_train is per rank per step of the "
                          "two-rank data-parallel step; launches_sr_model "
                          f"over the {SR_STEPS} steps of VQGAN stage-1 "
                          "training (SRModel), which reaches no TPU kernel "
                          "in the JAX package either; launches_train_options "
                          f"over the {OPTION_STEPS} timed steps with a fixed "
                          "GAN weight and weight decay, "
                          "launches_train_telemetry over one step with "
                          "telemetry=True, launches_model_api_mesh per rank "
                          "per step of the tiny two-rank model API, "
                          "launches_blocks over the blocks phase, "
                          "launches_data_utils over the data_utils phase's "
                          "profiled frame batch; K3 is the op "
                          "samt::conv3x3"),
        kernel_entry(
            "conv3x3_nhwc", "conv3x3_wgmma.cu", "pallas_conv.py:39",
            report["k4_cases"], "k3_launches_per_step",
            report["train_path"]["k4_launches"],
            f"sum over the {k3_per_step // 2} forward 3x3 convs of one "
            f"flagship train step at batch {TRAIN_BATCH}, in NHWC, bf16, on "
            f"the wgmma kernel; library_ms is F.conv2d on channels_last "
            f"tensors; the ragged shapes are checked, not summed; "
            f"device_ms, wpack_device_ms, mma_device_ms and "
            f"library_device_ms as for conv3x3",
            sources=[f"synergize_motion_appearance_tpu_torch/csrc/{s}" for s
                     in ("conv3x3_wgmma.cu", "conv3x3.cu")],
            launches_note="no path calls it, in the port or the JAX "
                          "package: 0 launches on the inference path, the "
                          "train step and the train CLI",
            launches_train_cli=cli["k4"]),
    ]
    watts = float(card.rsplit(",", 1)[-1].split()[0])
    report["speed_check"] = {}
    by_name = {k["name"]: k for k in kernels}
    for name, key, prev in PREVIOUS_MS:
        k = by_name[name]
        checked = watts >= 700.0
        report["speed_check"][f"{name}:{key}"] = {
            "key": key, "ms": k[key], "previous_ms": prev, "watts": watts,
            "checked": checked}
        print(f"{k['name']}: {key} {k[key]:.2f} against {prev} before "
              f"({k[key] / prev:.3f}x) at {watts} W; speed check "
              + ("(at most 1.1x) run" if checked else
                 "SKIPPED: this card's power limit is below the 700 W "
                 "of the previous time"),
              flush=True)
        if checked:
            assert k[key] <= 1.1 * prev, (k["name"], key, k[key], prev)
    report["kernels"] = kernels
    seconds = dict(report.seconds)
    print("phase seconds (wall; each report key and the phase that made "
          "it): " + ", ".join(f"{key} {t:.1f}" for key, t in seconds.items())
          + f"; build {build_s:.1f}, whole script "
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    report["phase_seconds"] = seconds
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
