"""3x3, stride-1, pad-1 convolution plus bias (kernels K3 and K4 of the
port).

Counterpart of ``synergize_motion_appearance_tpu/ops/pallas_conv_wl.py``'s
``conv3x3_wl`` and its differentiable wrapper ``conv3x3_wl_ad``, in the
port's NCHW layout: x (B, C, H, W), w (Cout, C, 3, 3) as ``nn.Conv2d``
holds it, optional bias (Cout,). Returns (B, Cout, H, W) in x's dtype,
accumulated in float32 (float64 for float64 inputs, as the JAX package).

``conv3x3`` is the ``torch.library`` custom op ``samt::conv3x3``. On a CUDA
tensor it launches a hand-written kernel (below) or raises;
on a CPU tensor it runs ``conv3x3_reference``, the plain PyTorch version,
which the tests hold against the JAX package and the on-card check holds
the kernel against. Its fake implementation gives the output's shape to
tracing, and a checkpoint policy can name it (``training.trainer``'s
selective remat saves its outputs).
The gradient is laid out like ``conv3x3_wl_ad``'s custom VJP: the input
gradient is the same kernel on dy with the weights rotated 180 degrees and
their channels swapped, the weight gradient 9 shifted float32 contractions,
the bias gradient a sum. On the card the kernel reads w as it is and
does the rotation in its weight packing (``conv3x3_input_grad``).

Which kernel a CUDA call launches is ``plan``'s choice, with no fallback
(a failed build or launch raises RuntimeError): bfloat16 runs on the
tensor cores, by ``wgmma`` (``csrc/conv3x3_wgmma.cu``: TMA-loaded halo
tiles, one producer warp, one consumer warpgroup) wherever TMA's tensor
maps can read the input, else by ``mma.sync`` (``csrc/conv3x3.cu``'s
``conv3x3_kernel_tc``); float32 runs on the CUDA cores, in full float32.
Both bfloat16 kernels take the weights from a packed copy that their
library writes just before (``pack_weights_reference`` is its plain
version) into scratch the wrapper allocates; each kernel's tile shape
comes from the problem's shape (``choose_wgmma_tile``, ``choose_tile``).
``launch_kernels`` counts the launches by kernel. ``conv3x3_by`` and
``conv3x3_nhwc_by`` launch a named kernel, to compare two at one shape.

``conv3x3_nhwc`` (K4) is the counterpart of ``ops/pallas_conv.py``'s
``conv3x3_pallas``: NHWC x, HWIO w, the same kernels in their NHWC
instantiations, with ``conv3x3_nhwc_reference`` as its plain version. It
keeps that function's own rules (w rounded to x's dtype, float32
accumulation for every input type, the bias added in float32) and, like
it, has no gradient.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cuda_build

# Kernel launches made by `conv3x3` (forward and input gradient) since the
# last reset, how many of them were input gradients, how many ran at each
# (B, C, Cout, H, W, dtype name) and by each kernel ("wgmma", "mma",
# "f32"); and those made by `conv3x3_nhwc`, in all and by kernel.
launches = 0
input_grad_launches = 0
launch_shapes: Counter = Counter()
launch_kernels: Counter = Counter()
nhwc_launches = 0
nhwc_launch_kernels: Counter = Counter()


def reset_launches() -> None:
    global launches, input_grad_launches, nhwc_launches
    launches = 0
    input_grad_launches = 0
    nhwc_launches = 0
    launch_shapes.clear()
    launch_kernels.clear()
    nhwc_launch_kernels.clear()


def _acc_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def conv3x3_reference(x, w, b=None):
    """Plain version: 9 shifted multiply-accumulates in float32 (float64
    for float64 inputs), the output rounded once to x's dtype."""
    B, C, H, W = x.shape
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (1, 1, 1, 1))
    wf = w.to(acc)
    out = torch.zeros(B, w.shape[0], H, W, dtype=acc, device=x.device)
    for ky in range(3):
        for kx in range(3):
            out = out + torch.einsum("bchw,oc->bohw",
                                     xp[:, :, ky:ky + H, kx:kx + W],
                                     wf[:, :, ky, kx])
    if b is not None:
        out = out + b.to(acc)[None, :, None, None]
    return out.to(x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The mma.sync kernel's tile shapes, (output rows, output columns, output
# channels) per block, in the order of csrc/conv3x3.cu's `tile` argument.
TILES = ((2, 64, 128), (4, 64, 64), (2, 32, 64))
# The wgmma kernel's, in the order of csrc/conv3x3_wgmma.cu's `tile`
# argument; its input channels per staged chunk; and by layout, the pixels
# of a staged halo row and how many of them lie left of the tile's 64
# columns (NHWC: one neighbour each side, rounded up to 8 pixels; NCHW:
# from the 8-pixel run before the tile, as a box's start must be 16-byte
# aligned there).
WGMMA_TILES = ((2, 64, 128), (2, 64, 64), (1, 64, 128), (1, 64, 64))
WGMMA_CHUNK = 64
NCHW, NHWC = 0, 1  # layouts of x and y
WGMMA_HALO = {NHWC: (72, 1), NCHW: (80, 8)}
# both bfloat16 kernels' packed weights: (9, Cout padded to PACK_CO, C
# padded to PACK_CI)
PACK_CO, PACK_CI = 128, 16
# packing modes: w (Cout, C, 3, 3); w (C, Cout, 3, 3) of the conv being
# differentiated, rotated and channel-swapped; w (3, 3, C, Cout)
PACK_OIHW, PACK_FLIP, PACK_HWIO = 0, 1, 2

_sm_counts: dict = {}
_entries: dict = {}


def _entry(library, name, n_ints):
    """csrc/<library>.cu's C entry ``name``, typed once: five pointers,
    ``n_ints`` ints, the stream."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(library), name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _blocks(tile, B, H, W, Cout, tiles=TILES):
    th, tw, bn = tiles[tile]
    return B * -(-H // th) * -(-W // tw) * -(-Cout // bn)


def choose_tile(B, H, W, Cout, n_sms):
    """The mma.sync kernel's tile shape for an output of (B, Cout, H, W):
    128 output channels per block above 64 channels, else 64 channels over
    4 rows; the small 2 x 32 x 64 tile when that grid has fewer blocks than
    the card has SMs."""
    tile = 0 if Cout > 64 else 1
    return tile if _blocks(tile, B, H, W, Cout) >= n_sms else 2


def choose_wgmma_tile(B, H, W, Cout, n_sms):
    """The wgmma kernel's tile shape for an output of (B, Cout, H, W). One
    block runs on an SM at a time, so a grid takes ceil(blocks / SMs)
    waves, each as long as one block's work (rows x channels of its tile):
    the tile with the fewest waves times that work, the first of
    WGMMA_TILES on a tie; the 128-channel tiles only above 64 output
    channels, where they compute no padding."""
    def cost(tile):
        th, _, bn = WGMMA_TILES[tile]
        blocks = _blocks(tile, B, H, W, Cout, WGMMA_TILES)
        return -(-blocks // n_sms) * th * bn

    tiles = [i for i, (_, _, bn) in enumerate(WGMMA_TILES)
             if Cout > 64 or bn <= 64]
    return min(tiles, key=cost)


class Plan(NamedTuple):
    """The kernel a call launches: ``kernel`` is "wgmma", "mma" or "f32";
    ``tile`` its tile shape (an index of WGMMA_TILES or TILES; 0 for f32);
    ``pair``: the wgmma kernel's NCHW 64-channel tile in its geometry of
    two blocks an SM (one input stage and one pixel tile a block)."""
    kernel: str
    tile: int
    pair: bool = False


def plan(dtype, layout, B, C, H, W, Cout, sms, pointers) -> Plan:
    """Which kernel runs a call, by dtype, layout (NCHW or NHWC), shape and
    the addresses of x and y (no fallback: the plan's kernel launches or
    the call raises). float32: the CUDA-core kernel. bfloat16: the wgmma
    kernel where TMA's tensor maps can read x and write nothing amiss: every
    pointer 16-byte aligned, and the stride of an NCHW row (W) or of an NHWC
    pixel (C) a multiple of 16 bytes, that is of 8 values; else the
    mma.sync kernel. Both take any B, C, H, W and Cout. The wgmma kernel's
    NCHW 64-channel tiles pair two blocks an SM where the grid has at
    least two blocks an SM: their copies, transposition and epilogue then
    run under the other block's wgmmas, which gains more than running a
    block's chunks one after another costs (with fewer blocks, the paired
    geometry ran the train step's 64^2 shapes slower than one block an
    SM)."""
    if dtype == torch.float32:
        return Plan("f32", 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"no conv3x3 kernel for {dtype}")
    if (W if layout == NCHW else C) % 8 == 0 and all(
            p % 16 == 0 for p in pointers):
        tile = choose_wgmma_tile(B, H, W, Cout, sms)
        pair = layout == NCHW and WGMMA_TILES[tile][2] == 64 and _blocks(
            tile, B, H, W, Cout, WGMMA_TILES) >= 2 * sms
        return Plan("wgmma", tile, pair)
    return Plan("mma", choose_tile(B, H, W, Cout, sms))


def pack_weights_reference(w, mode):
    """Plain version of the kernel's weight packing: (9, Coutp, Cp) with
    [tap, o, c] = the weight from input channel c to output channel o at
    tap ky * 3 + kx, zero in the padding (see PACK_* for the modes)."""
    if mode == PACK_OIHW:
        taps = w.permute(2, 3, 0, 1)
    elif mode == PACK_FLIP:
        taps = w.flip(2, 3).permute(2, 3, 1, 0)
    elif mode == PACK_HWIO:
        taps = w.permute(0, 1, 3, 2)
    else:
        raise ValueError(f"no packing mode {mode}")
    taps = taps.reshape(9, taps.shape[2], taps.shape[3])
    cout, c = taps.shape[1:]
    out = taps.new_zeros(9, -(-cout // PACK_CO) * PACK_CO,
                         -(-c // PACK_CI) * PACK_CI)
    out[:, :cout, :c] = taps
    return out


def _sms(device):
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]


def _launch(layout, x, w, b, y, mode, kernel=None):
    """Runs the conv of x into y on the card by the kernel ``plan`` picks,
    or by ``kernel`` ("mma" runs the mma.sync kernel where the plan is
    wgmma; another kernel than the plan's raises); returns the kernel's
    name. A bfloat16 kernel's packed-weight scratch may be freed as soon as
    the launch returns: it is allocated on the stream the kernel runs on,
    and the caching allocator gives it out again only to work queued after
    the kernel on that stream."""
    if layout == NCHW:
        B, C, H, W = x.shape
        Cout = y.shape[1]
    else:
        B, H, W, C = x.shape
        Cout = y.shape[3]
    p = plan(x.dtype, layout, B, C, H, W, Cout, _sms(x.device),
             (x.data_ptr(), y.data_ptr()))
    if kernel == "mma" and p.kernel == "wgmma":
        p = Plan("mma", choose_tile(B, H, W, Cout, _sms(x.device)))
    elif kernel not in (None, p.kernel):
        raise ValueError(f"the {kernel} kernel does not take this call; its "
                         f"plan is {p}")
    wpack = None if p.kernel == "f32" else torch.empty(
        9 * -(-Cout // PACK_CO) * PACK_CO * -(-C // PACK_CI) * PACK_CI,
        dtype=torch.bfloat16, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), None if wpack is None else wpack.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.kernel == "wgmma":
        fn = _entry("conv3x3_wgmma", "samt_conv3x3_wgmma", 9)
        args = (B, C, H, W, Cout, layout, mode, p.tile, int(p.pair))
    elif layout == NCHW:
        fn = _entry("conv3x3", "samt_conv3x3", 8)
        args = (B, C, H, W, Cout, _DTYPES[x.dtype], int(mode == PACK_FLIP),
                p.tile)
    else:
        fn = _entry("conv3x3", "samt_conv3x3_nhwc", 7)
        args = (B, H, W, C, Cout, _DTYPES[x.dtype], p.tile)
    with torch.cuda.device(x.device):
        err = fn(*ptrs, *args, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 {p.kernel} kernel launch failed with "
                           f"CUDA error {err}")
    return p.kernel


def _check(x, w, b):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"want x (B, C, H, W) and w (Cout, C, 3, 3); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} does not take {x.shape[1]} "
                         f"input channels")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got "
                         f"{tuple(b.shape)}")


def _launch_cuda(x, w, b, flip=False, kernel=None):
    """flip: w is (C, Cout, 3, 3), the weights of the conv whose input
    gradient this is; the kernel rotates and channel-swaps them."""
    global launches, input_grad_launches
    B, C, H, W = x.shape
    Cout = w.shape[1] if flip else w.shape[0]
    tensors = [x, w] + ([b] if b is not None else [])
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"x, w and bias must share float32 or bfloat16; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w and bias must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("x, w and bias must be contiguous")
    y = torch.empty(B, Cout, H, W, dtype=x.dtype, device=x.device)
    name = _launch(NCHW, x, w, b, y, PACK_FLIP if flip else PACK_OIHW,
                   kernel)
    launches += 1
    input_grad_launches += int(flip)
    launch_shapes[(B, C, Cout, H, W, str(x.dtype).split(".")[1])] += 1
    launch_kernels[name] += 1
    return y


def conv3x3_by(kernel, x, w, b=None, flip=False):
    """The conv of a CUDA x, or with flip its input gradient (w then the
    (Cout, C, 3, 3) weights of the conv differentiated), by the named
    kernel ("wgmma", "mma" or "f32"; see ``_launch``), counted as
    ``conv3x3``'s launches are: for comparing the kernels at one shape.
    The op ``conv3x3`` launches the planned kernel."""
    _check(x, w.transpose(0, 1) if flip else w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_by runs CUDA tensors, not {x.device}")
    return _launch_cuda(x.contiguous(), w.contiguous(),
                        None if b is None else b.contiguous(), flip, kernel)


def flipped_weights(w):
    """(Cout, C, 3, 3) -> (C, Cout, 3, 3): rotated 180 degrees, channels
    swapped; the conv with these is the input gradient of the conv with w."""
    return w.flip(2, 3).transpose(0, 1).contiguous()


def conv3x3_input_grad(dy, w):
    """dx of the conv with w (Cout, C, 3, 3) at output gradient dy
    (B, Cout, H, W): the conv of dy with ``flipped_weights(w)``. On the
    card the kernel reads w as it is and rotates it in its weight packing,
    so no flipped copy is made."""
    if dy.dim() != 4 or w.dim() != 4 or w.shape[0] != dy.shape[1]:
        raise ValueError(f"want dy (B, Cout, H, W) and w (Cout, C, 3, 3); "
                         f"got {tuple(dy.shape)} and {tuple(w.shape)}")
    if dy.device.type == "cpu":
        return conv3x3_reference(dy, flipped_weights(w))
    if dy.device.type == "cuda":
        return _launch_cuda(dy.contiguous(), w.contiguous(), None, flip=True)
    raise ValueError(f"no conv3x3 for device {dy.device}")


def weight_grad(x, dy):
    """dw[o, c, ky, kx] = sum over (b, h, w) of xpad[b, c, h+ky, w+kx] *
    dy[b, o, h, w], as 9 float32 (float64) contractions; in x's dtype."""
    B, C, H, W = x.shape
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (1, 1, 1, 1))
    dyf = dy.to(acc).reshape(B, dy.shape[1], H * W)
    taps = [torch.einsum("bop,bcp->oc", dyf,
                         xp[:, :, ky:ky + H, kx:kx + W].reshape(B, C, H * W))
            for ky in range(3) for kx in range(3)]
    dw = torch.stack(taps, dim=-1).reshape(dy.shape[1], C, 3, 3)
    return dw.to(x.dtype)


@torch.library.custom_op("samt::conv3x3", mutates_args=(),
                         device_types="cpu")
def _conv_op(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    return conv3x3_reference(x, w, b)


@_conv_op.register_kernel("cuda")
def _conv_cuda(x, w, b):
    return _launch_cuda(x.contiguous(), w.contiguous(),
                        None if b is None else b.contiguous())


@_conv_op.register_fake
def _conv_fake(x, w, b):
    _check(x, w, b)
    return x.new_empty(x.shape[0], w.shape[0], x.shape[2], x.shape[3])


def _setup_context(ctx, inputs, output):
    x, w, b = inputs
    ctx.save_for_backward(x, w)
    ctx.has_bias = b is not None


def _backward(ctx, dy):
    """``conv3x3_wl_ad``'s VJP: the input gradient launches the kernel
    again, the weight and bias gradients are float32 contractions."""
    x, w = ctx.saved_tensors
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        dx = conv3x3_input_grad(dy, w)
    if ctx.needs_input_grad[1]:
        dw = weight_grad(x, dy).to(w.dtype)
    if ctx.has_bias and ctx.needs_input_grad[2]:
        db = dy.to(_acc_dtype(dy)).sum(dim=(0, 2, 3)).to(dy.dtype)
    return dx, dw, db


_conv_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3(x, w, b: Optional[torch.Tensor] = None):
    """3x3, stride-1, pad-1 conv plus bias (see the module docstring), as
    the op ``samt::conv3x3``."""
    _check(x, w, b)
    return torch.ops.samt.conv3x3(x, w, b)


# ---------------------------------------------------------------------------
# K4: the NHWC layout of conv3x3_pallas
# ---------------------------------------------------------------------------

def conv3x3_nhwc_reference(x, w, b=None):
    """Plain version of ``conv3x3_pallas`` (ops/pallas_conv.py:96-127): x
    (B, H, W, C), w (3, 3, C, Cout) rounded to x's dtype, 9 shifted
    products accumulated in float32 whatever x's dtype (each tap's sum in
    x's dtype promoted to float32, then rounded to float32), the bias (zeros
    when None) added in float32 from its own dtype; the output in x's
    dtype."""
    B, H, W, C = x.shape
    tap_dt = _acc_dtype(x)
    xp = F.pad(x.to(tap_dt), (0, 0, 1, 1, 1, 1))
    wq = w.to(x.dtype).to(tap_dt)
    out = torch.zeros(B, H, W, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            out = out + torch.einsum("bhwc,co->bhwo",
                                     xp[:, ky:ky + H, kx:kx + W, :],
                                     wq[ky, kx]).float()
    if b is None:
        b = torch.zeros(w.shape[-1], dtype=x.dtype, device=x.device)
    return (out + b.float()).to(x.dtype)


def _check_nhwc(x, w, b):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"want x (B, H, W, C) and w (3, 3, C, Cout); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} does not take {x.shape[3]} "
                         f"input channels")
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got "
                         f"{tuple(b.shape)}")


def _launch_cuda_nhwc(x, w, b, kernel=None):
    global nhwc_launches
    B, H, W, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    tensors = [x, w] + ([b] if b is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w and bias must be on one CUDA device")
    # the function's own roundings: w to x's dtype, the bias to float32
    # (exact from float32 and bfloat16)
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b = None if b is None else b.float().contiguous()
    y = torch.empty(B, H, W, w.shape[3], dtype=x.dtype, device=x.device)
    name = _launch(NHWC, x, w, b, y, PACK_HWIO, kernel)
    nhwc_launches += 1
    nhwc_launch_kernels[name] += 1
    return y


def conv3x3_nhwc_by(kernel, x, w, b=None):
    """``conv3x3_nhwc`` of a CUDA x by the named kernel, as
    ``conv3x3_by``."""
    _check_nhwc(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_nhwc_by runs CUDA tensors, not "
                         f"{x.device}")
    return _launch_cuda_nhwc(x, w, b, kernel)


class _Conv3x3NHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        if x.device.type == "cpu":
            return conv3x3_nhwc_reference(x, w, b)
        if x.device.type == "cuda":
            return _launch_cuda_nhwc(x, w, b)
        raise ValueError(f"no conv3x3_nhwc for device {x.device}")

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "conv3x3_nhwc has no gradient: conv3x3_pallas, its JAX "
            "counterpart, is a raw pallas_call without a VJP")


def conv3x3_nhwc(x, w, b: Optional[torch.Tensor] = None):
    """3x3, stride-1, pad-1 conv plus bias in NHWC with HWIO weights, as
    ``conv3x3_pallas`` computes it (see ``conv3x3_nhwc_reference``).
    Forward only: a backward through it raises NotImplementedError."""
    _check_nhwc(x, w, b)
    return _Conv3x3NHWC.apply(x, w, b)
