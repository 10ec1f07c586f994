"""Fused softmax attention in two layouts (kernels K1 and K2 of the port).

Counterparts of ``synergize_motion_appearance_tpu/ops/fused_attention.py``'s
``fused_attention_packed`` (K1) and ``fused_attention`` (K2):
- ``fused_attention_packed``: token-major q (B, L, E) with H heads of
  d = E / H; k, v (B, K, E), or one (K, E) context shared by the batch (the
  codebook, never broadcast in memory). Returns (B, L, E).
- ``fused_attention``: head-split q (B, H, L, d); k, v (B, H, K, d), or one
  (1, H, K, d) context shared by the batch. Returns (B, H, L, d).
Both take an optional (B, K) additive bias where -1e30 masks a key, cast to
float32 as the JAX package casts it, take inputs of any strides (the CUDA
launch makes them contiguous), and return q's dtype.

Each layout is a ``torch.library`` custom op
(``torch.ops.samt.fused_attention_packed``,
``torch.ops.samt.fused_attention``), so that ``torch.export`` keeps the
call in an exported program. On a CUDA tensor the op launches a
hand-written kernel (given each layout's strides or tensor maps) or
raises; ``plan`` picks it by dtype and shape, for every head width d >= 1
(as the JAX package's Pallas kernels take any d): bfloat16 at d = 16, 32
and 64 runs on Hopper's warpgroup tensor cores
(``attn_packed_kernel_wgmma`` of ``csrc/fused_attention_wgmma.cu``: TMA,
``wgmma``, warp specialisation), and so does bfloat16 at d = 65..512 with
d % 8 = 0: d = 65..128 on ``attn_packed_kernel_wgmma128<D, ..>`` of
``csrc/fused_attention_wgmma128.cu`` (persistent blocks over items of 128
query rows, in two consumer warpgroups that take turns on the tensor
cores), d = 129..256 on ``attn_packed_kernel_wgmma256<D, ..>`` of
``csrc/fused_attention_wgmma256.cu`` (a block all D output columns of its
64 query rows), both at D = d rounded up to 32 columns, d = 257..512 on
``attn_packed_kernel_wgmma512<W, ..>`` of
``csrc/fused_attention_wgmma512.cu`` (two blocks a head row's 64 query
rows, each W = d rounded up to 64, halved, output columns and the whole
q.k); the other bfloat16 widths up to 64 run on ``mma.sync``
(``attn_packed_kernel_tc`` of ``csrc/fused_attention_packed.cu``, in the
variant ``tc_plan`` and ``copy_bytes`` pick), float32 up to 64 on the
CUDA cores (``attn_packed_kernel``, ``f32_rows`` query rows a thread).
The kernels of ``csrc/fused_attention_chunked.cu`` take the rest: float32
at d = 65..1024 ``attn_packed_kernel_f32wide`` (CUDA cores, a block all
output columns of its query rows), d = 1 in either dtype the CUDA-core
``attn_packed_kernel_chunked_f32<1, 1, T>``, and the d-chunked kernels
(a block a chunk of at most 64 output columns) bfloat16 above 64 where
the wgmma kernels do not run (d % 8 != 0, pointers TMA cannot take,
above 512) and float32 above 1024. On a CPU
tensor it runs the plain PyTorch version
(``fused_attention_packed_reference``, ``fused_attention_reference``),
which the tests hold against the JAX package and the on-card check holds
the kernel against; no other device has an implementation. The fake
implementation checks what the kernel takes, without data. The gradient
differentiates the plain version, as the JAX package's custom VJPs do
(there is no backward kernel).

Inside ``plain_cpu_attention()`` a call on CPU tensors runs the plain
version's ATen operators in place of the op, so that a program traced on
the CPU holds no ``samt`` op: the CPU programs of a two-device serving
artifact, as the JAX package traces its portable dense attention for a
multi-platform export. A call on CUDA tensors still reaches the op.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math
from collections import Counter
from typing import NamedTuple, Optional

import torch

from . import cuda_build

# Kernel launches since the last reset, of either dtype's kernel: by
# `fused_attention_packed` (K1) and by `fused_attention` (K2); and of both,
# by the kernel `plan` named ("wgmma", "wgmma128", "wgmma256", "wgmma512",
# "mma", "f32", "f32wide", "d1", "chunked").
launches = 0
split_launches = 0
launch_kernels: Counter = Counter()


def reset_launches() -> None:
    global launches, split_launches
    launches = 0
    split_launches = 0
    launch_kernels.clear()


_PLAIN_CPU = contextvars.ContextVar("samt_plain_cpu_attention",
                                    default=False)


@contextlib.contextmanager
def plain_cpu_attention():
    """Scope in which attention on CPU tensors is traced as the plain
    version's operators (see the module docstring)."""
    tok = _PLAIN_CPU.set(True)
    try:
        yield
    finally:
        _PLAIN_CPU.reset(tok)


def fused_attention_reference(q, k, v, bias=None):
    """Plain version of the head-split layout: the JAX package's
    ``_dense_reference`` (ops/fused_attention.py:38-53), transliterated,
    plus the kernel's all-masked-row rule.

    A row whose every key carries the -1e30 bias has uniform softmax
    weights, so the JAX dense reference returns the mean of v there; the
    TPU kernels multiply such rows by (max score > -1e29) and return 0
    (:92-95). This version applies the kernels' rule, so it answers what
    the kernel answers."""
    d = q.shape[-1]
    if k.shape[0] == 1 and q.shape[0] != 1:
        k = k.expand(q.shape[0], -1, -1, -1)
        v = v.expand(q.shape[0], -1, -1, -1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    if bias is not None:
        scores = scores + bias[:, None, None, :].float()
    attn = torch.nan_to_num(torch.softmax(scores, dim=-1))
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v.float())
    if bias is not None:
        out = out * (scores.amax(dim=-1, keepdim=True) > -1e29)
    return out.to(q.dtype)


def fused_attention_packed_reference(q, k, v, bias=None, *, num_heads: int):
    """Plain version of the token-major layout: the JAX package's
    ``_dense_reference_packed`` (:210-224), which splits the heads, runs
    the head-split version and merges them."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]

    def split(t):  # contiguous, as the head-split version's callers pass
        if t.dim() == 2:
            t = t.reshape(1, K, H, d)
        else:
            t = t.reshape(t.shape[0], t.shape[1], H, d)
        return t.permute(0, 2, 1, 3).contiguous()

    out = fused_attention_reference(split(q), split(k), split(v), bias)
    return out.permute(0, 2, 1, 3).reshape(B, L, E)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# head widths of the bfloat16 wgmma kernel (attn_packed_kernel_wgmma<D, ..>):
# a row of a head is one TMA box row of 32, 64 or 128 bytes, swizzled by
# its own width, and a multiple of wgmma's depth of 16; its query rows per
# block, at every grid, as the d = 256 kernel's (three blocks share an SM,
# one at d = 256)
WGMMA_WIDTHS = (16, 32, 64)
WGMMA_ROWS = 64
# query rows per item of the d = 128 wgmma kernel's persistent blocks:
# two consumer warpgroups of 64, one block an SM
WGMMA128_ROWS = 128
# the widths of the d = 128, d = 256 and d = 512 wgmma designs
# (attn_packed_kernel_wgmma128<D, ..>, _wgmma256<D, ..> and
# _wgmma512<W, ..>): bf16 d = 65..128, 129..256 and 257..512 with d % 8 = 0
# (a head row's bytes a multiple of 16, the stride TMA takes), at D =
# wgmma_cols(d) columns, and for the d = 512 design in two parts of W =
# wgmma512_part(d) columns
WGMMA128_MIN_D = 65
WGMMA256_MAX_D = 256
WGMMA512_MAX_D = 512
# query rows per block of the d-chunked kernels, by dtype
# (attn_packed_kernel_chunked_tc: 16 a warp; _f32: one a thread), and of the
# d = 1 kernel (one a thread, either dtype)
CHUNKED_ROWS = {torch.bfloat16: 64, torch.float32: 128}
D1_ROWS = 128
# the float32 wide kernel (attn_packed_kernel_f32wide<C>) takes d above 64
# up to F32WIDE_MAX_D: all columns of its query rows, d rounded up to C =
# 128, 256, .., 1024; 16384 / C rows a block up to 256, so that q fills
# 64 KiB of shared memory, 32 up to 768 and 16 past it, with 512-key
# super-tiles past 256 (256-key ones at 640 and 768; the JAX package's
# Pallas kernels reach E = 511 at L = K = 1024, and wider heads at shorter
# lengths)
F32WIDE_MAX_D = 1024


def f32wide_cols(d: int) -> int:
    """The float32 wide kernel's column count C at head width d."""
    return -(-d // 128) * 128


def f32wide_rows(d: int) -> int:
    """Query rows per block of the float32 wide kernel at head width d."""
    return 16384 // f32wide_cols(d) if d <= 256 else 32 if d <= 768 else 16


def wgmma_cols(d: int) -> int:
    """The column count D of the d = 128 / 256 wgmma designs at head
    width d: d rounded up to 32 (a 64-column TMA box a full part, a
    32-column one for the rest)."""
    return -(-d // 32) * 32


def wgmma512_part(d: int) -> int:
    """The part width W of the d = 512 wgmma design at head width d: d
    rounded up to 64, halved (a head row's two parts, each a block)."""
    return -(-d // 64) * 32


# C entry samt_attention_chunked's kernel argument, by plan kernel
CHUNKED_ENTRY_KERNELS = {"chunked": 0, "d1": 1, "f32wide": 2}


class Plan(NamedTuple):
    """The kernel a call launches: ``kernel`` is "wgmma", "wgmma128",
    "wgmma256", "wgmma512", "mma", "f32", "f32wide", "d1" or "chunked";
    ``rows`` its query rows per block (wgmma: always 64, one consumer
    warpgroup, as wgmma256 and wgmma512; wgmma128: 128 an item, two;
    f32wide: ``f32wide_rows``; mma; d1; chunked) or per thread (f32);
    ``nv`` and
    ``copy_bytes`` the mma.sync variant's P.V width in n8 tiles and bytes
    per cp.async of a key row (0 for the others)."""
    kernel: str
    rows: int
    nv: int = 0
    copy_bytes: int = 0


def plan(dtype, B: int, H: int, L: int, d: int, sms: int, q_ptr: int,
         k_ptr: int, v_ptr: int, out_ptr: int) -> Plan:
    """Which kernel runs a call, by dtype, shape and the tensors'
    addresses, for every head width d >= 1 (no fallback: the plan's kernel
    launches or the call raises). bfloat16 where q, k, v and out are
    16-byte aligned (TMA's rule for a tensor map's base): the wgmma kernel
    where d is in WGMMA_WIDTHS; at d % 8 = 0 the d = 128 wgmma design at
    d = 65..128 and the d = 256 one at d = 129..256, each at
    ``wgmma_cols(d)`` columns, and the d = 512 one at d = 257..512, in two
    parts of ``wgmma512_part(d)`` columns.
    Else: d = 1, the CUDA-core d = 1 kernel of either dtype; float32 at
    d = 65..F32WIDE_MAX_D (1024) the float32 wide kernel; above 64 the
    rest (bf16 at d % 8 != 0, at other pointers or above 512, float32
    above F32WIDE_MAX_D) the d-chunked kernel of its dtype; at d = 2..64 the
    mma.sync kernel's ``tc_plan`` variant (bfloat16) or the CUDA-core
    kernel at ``f32_rows`` rows a thread (float32)."""
    if d < 1:
        raise ValueError(f"head width d={d}: no kernel takes it")
    if dtype == torch.bfloat16 and all(
            a % 16 == 0 for a in (q_ptr, k_ptr, v_ptr, out_ptr)):
        if d in WGMMA_WIDTHS:
            return Plan("wgmma", WGMMA_ROWS)
        if d % 8 == 0 and WGMMA128_MIN_D <= d <= 128:
            return Plan("wgmma128", WGMMA128_ROWS)
        if d % 8 == 0 and 128 < d <= WGMMA256_MAX_D:
            return Plan("wgmma256", WGMMA_ROWS)
        if d % 8 == 0 and WGMMA256_MAX_D < d <= WGMMA512_MAX_D:
            return Plan("wgmma512", WGMMA_ROWS)
    if d == 1:
        return Plan("d1", D1_ROWS)
    if dtype == torch.float32 and 8 * TC_WIDTHS[-1] < d <= F32WIDE_MAX_D:
        return Plan("f32wide", f32wide_rows(d))
    if d > 8 * TC_WIDTHS[-1]:
        return Plan("chunked", CHUNKED_ROWS[dtype])
    if dtype == torch.float32:
        return Plan("f32", f32_rows(B, H, L, d, sms))
    nv, _, rows = tc_plan(B, H, L, d, sms)
    return Plan("mma", rows, nv, copy_bytes(d, k_ptr, v_ptr))


def f32_rows(B: int, H: int, L: int, d: int, sms: int) -> int:
    """Query rows per thread of the float32 kernel (128 threads a block):
    the most of 4, 2 and 1 that the head width allows (4 at d <= 8, 2 at
    d <= 16, 1 above, where the rows' q and accumulators would crowd the
    registers) and that still leaves two blocks an SM; 1 where even that
    does not (the train step's B = 2), since each staged key then serves
    fewer rows but more threads share the card."""
    for rows in (4, 2):
        if d <= 32 // rows and B * H * -(-L // (128 * rows)) >= 2 * sms:
            return rows
    return 1


# P.V widths of the mma.sync kernel's variants, in n8 tiles: 8, 16, 32 and
# 64 columns (attn_packed_kernel_tc<NV, ONES>)
TC_WIDTHS = (1, 2, 4, 8)


def tc_plan(B: int, H: int, L: int, d: int, sms: int):
    """The mma.sync kernel's variant for a bfloat16 call (``plan`` sends
    it the widths the wgmma kernel does not take): (nv, ones, rows).

    nv: the narrowest P.V width of 8*nv columns that holds the d values;
    ones: whether column d is spare (d < 8*nv), in which case the staged v
    tile carries ones there and P.V returns the row sums; rows: query rows
    per block (32 a warp), 128 (k and v staged once for twice the rows)
    when that still gives at least 4 blocks per SM, else 64. The kernel
    takes d = 2..64 (``plan`` sends the other widths to the d-chunked
    kernel)."""
    if not 2 <= d <= 8 * TC_WIDTHS[-1]:
        raise ValueError(f"head width d={d} is outside the mma.sync "
                         f"kernel's 2..64")
    nv = next(n for n in TC_WIDTHS if 8 * n >= d)
    rows = 128 if B * H * -(-L // 128) >= 4 * sms else 64
    return nv, d < 8 * nv, rows


def copy_bytes(d: int, *addresses: int) -> int:
    """Bytes per cp.async of a key row's d bf16 values: the widest of 16,
    8 and 4 that divides the row (2d bytes; every k/v stride of both
    layouts is a multiple of d) and every address, else 0 (copied through
    registers)."""
    for n in (16, 8, 4):
        if (2 * d) % n == 0 and all(a % n == 0 for a in addresses):
            return n
    return 0


def _check(q, k, v, bias, num_heads):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, L, E), got {tuple(q.shape)}")
    B, L, E = q.shape
    if k.shape != v.shape or k.dim() not in (2, 3):
        raise ValueError(f"k, v must both be (B, K, E) or (K, E); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[-1] != E or (k.dim() == 3 and k.shape[0] != B):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if num_heads <= 0 or E % num_heads != 0:
        raise ValueError(f"num_heads={num_heads} does not divide E={E}")
    if bias is not None and tuple(bias.shape) != (B, k.shape[-2]):
        raise ValueError(f"bias must be (B, K) = {(B, k.shape[-2])}, got "
                         f"{tuple(bias.shape)}")


def _check_split(q, k, v, bias):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, d), got {tuple(q.shape)}")
    B, H, L, d = q.shape
    if k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"k, v must both be (B, H, K, d) or (1, H, K, d); "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[0] not in (1, B) or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if bias is not None and tuple(bias.shape) != (B, k.shape[2]):
        raise ValueError(f"bias must be (B, K) = {(B, k.shape[2])}, got "
                         f"{tuple(bias.shape)}")


def _check_cuda(q, k, v, bias, num_heads):
    """What the kernel takes beyond the layout checks; returns (B, H, L,
    K, d). Runs on real and on fake tensors, so that ``torch.export``
    fails where a launch would."""
    if num_heads is None:
        B, H, L, d = q.shape
        K = k.shape[2]
    else:
        B, L, E = q.shape
        H, K, d = num_heads, k.shape[-2], E // num_heads
    if d < 1:
        raise ValueError(f"head width d={d}: no kernel takes it")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and bias must be on one CUDA device")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    return B, H, L, K, d


def _launch_cuda(q, k, v, bias, num_heads):
    """Launches the kernel ``plan`` picks, in the token-major layout
    (num_heads given) or the head-split one (num_heads None), on
    contiguous copies of inputs with other strides (the kernels read rows
    at the layouts' strides, as the conv ops' launches do)."""
    global launches, split_launches
    B, H, L, K, d = _check_cuda(q, k, v, bias, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    p = plan(q.dtype, B, H, L, d, sms, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr())
    split = num_heads is None
    kv_shared = int(k.shape[0] == 1 and B != 1) if split else int(
        k.dim() == 2)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if p.kernel in ("wgmma", "wgmma128", "wgmma256", "wgmma512"):
        fn = getattr(cuda_build.load(f"fused_attention_{p.kernel}"),
                     f"samt_attention_{p.kernel}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        args = (*ptrs, B, H, L, K, d, int(split), kv_shared,
                1.0 / math.sqrt(d), stream)
    elif p.kernel in CHUNKED_ENTRY_KERNELS:
        fn = cuda_build.load(
            "fused_attention_chunked").samt_attention_chunked
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        args = (*ptrs, B, H, L, K, d, int(split), kv_shared,
                1.0 / math.sqrt(d), _DTYPES[q.dtype],
                CHUNKED_ENTRY_KERNELS[p.kernel], stream)
    else:
        lib = cuda_build.load("fused_attention_packed")
        if split:
            fn = lib.samt_fused_attention_split
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            shape_args = (B, H, L, K, d, kv_shared)
        else:
            fn = lib.samt_fused_attention_packed
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            shape_args = (B, L, K, q.shape[2], H,
                          0 if kv_shared else K * q.shape[2])
        args = (*ptrs, *shape_args, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
                p.nv, p.rows, p.copy_bytes, stream)
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"fused attention kernel ({p.kernel}) launch "
                           f"failed with CUDA error {err}")
    if split:
        split_launches += 1
    else:
        launches += 1
    launch_kernels[p.kernel] += 1
    return out


def _reference(q, k, v, bias, num_heads):
    if num_heads is None:
        return fused_attention_reference(q, k, v, bias)
    return fused_attention_packed_reference(q, k, v, bias,
                                            num_heads=num_heads)


@torch.library.custom_op("samt::fused_attention_packed", mutates_args=(),
                         device_types="cpu")
def _packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    return _reference(q, k, v, bias, num_heads)


@torch.library.custom_op("samt::fused_attention", mutates_args=(),
                         device_types="cpu")
def _split_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _reference(q, k, v, bias, None).contiguous()


@_packed_op.register_kernel("cuda")
def _packed_cuda(q, k, v, bias, num_heads):
    return _launch_cuda(q, k, v, bias, num_heads)


@_split_op.register_kernel("cuda")
def _split_cuda(q, k, v, bias):
    return _launch_cuda(q, k, v, bias, None)


@_packed_op.register_fake
def _packed_fake(q, k, v, bias, num_heads):
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cuda":
        _check_cuda(q, k, v, bias, num_heads)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_split_op.register_fake
def _split_fake(q, k, v, bias):
    _check_split(q, k, v, bias)
    if q.device.type == "cuda":
        _check_cuda(q, k, v, bias, None)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    q, k, v, bias = inputs[:4]
    ctx.num_heads = inputs[4] if len(inputs) == 5 else None
    ctx.save_for_backward(q, k, v, bias)


def _backward(ctx, g):
    """The gradient of the plain version, as the JAX package's custom VJPs
    differentiate its dense reference (there is no backward kernel)."""
    q, k, v, bias = ctx.saved_tensors
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = _reference(qd, kd, vd, bias, ctx.num_heads)
        dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
    return (dq, dk, dv, None) + ((None,) if ctx.num_heads else ())


_packed_op.register_autograd(_backward, setup_context=_setup_context)
_split_op.register_autograd(_backward, setup_context=_setup_context)


def _f32_bias(bias):
    """The bias as the kernels take it: float32, as the JAX package casts
    it (``bias.astype(jnp.float32)``, its ops/fused_attention.py:126,
    290)."""
    return bias if bias is None or bias.dtype == torch.float32 else \
        bias.float()


def fused_attention(q, k, v, bias: Optional[torch.Tensor] = None):
    """Softmax attention in head-split layout (see the module docstring):
    q (B, H, L, d); k, v (B, H, K, d) or a shared (1, H, K, d); any
    strides."""
    _check_split(q, k, v, bias)
    bias = _f32_bias(bias)
    if _PLAIN_CPU.get() and q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
    return torch.ops.samt.fused_attention(q, k, v, bias)


def fused_attention_packed(q, k, v, bias: Optional[torch.Tensor] = None, *,
                           num_heads: int):
    """Softmax attention in token-major layout (see the module docstring).
    Heads are split and merged inside the kernel. Any strides."""
    _check(q, k, v, bias, num_heads)
    bias = _f32_bias(bias)
    if _PLAIN_CPU.get() and q.device.type == "cpu":
        return fused_attention_packed_reference(q, k, v, bias,
                                                num_heads=num_heads)
    return torch.ops.samt.fused_attention_packed(q, k, v, bias, num_heads)
