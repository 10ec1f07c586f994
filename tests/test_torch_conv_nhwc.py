"""Port of kernel K4 (the NHWC 3x3 conv ``conv3x3_pallas``): its plain
PyTorch version against the JAX package's Pallas kernel ``_conv_kernel``
run in interpret mode on the CPU, through a ``pl.pallas_call`` built here
with ``conv3x3_pallas``'s own specs (ops/pallas_conv.py:108-127), which
has no interpret flag; and against ``lax.conv_general_dilated`` at an H
that the Pallas kernel's row blocks cannot tile.

Tolerances: in float32, with unit-variance x and weights scaled so that
the outputs have unit variance too, 1e-4 absolute (both sides sum the
9 * C float32 products in other orders; ~1e-6 here). In bfloat16 both
sides accumulate in float32 and round once, so they may differ by one
bfloat16 ulp of the output.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from synergize_motion_appearance_tpu.ops.pallas_conv import (  # noqa: E402
    _PAD,
    _conv_kernel,
)
from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401


def _pallas_interpret(x, w, b, block_rows):
    """conv3x3_pallas's pallas_call, with interpret=True."""
    B, H, W, C = x.shape
    Cout = w.shape[-1]
    if b is None:
        b = jnp.zeros((Cout,), x.dtype)
    w9 = w.astype(x.dtype).reshape(9, C, Cout)
    kernel = functools.partial(_conv_kernel, block_rows=block_rows, H=H,
                               W=W, C=C)
    return pl.pallas_call(
        kernel,
        grid=(B, H // block_rows),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, block_rows, W, Cout),
                               lambda b_, i: (b_, i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, H, W, Cout), x.dtype),
        scratch_shapes=[
            pltpu.VMEM((block_rows + 2, _PAD + W + 16, C), x.dtype),
            pltpu.VMEM((block_rows * W, Cout), jnp.float32),
            pltpu.SemaphoreType.DMA(()),
        ],
        interpret=True,
    )(x, w9, b.reshape(1, Cout))


def _inputs(B, H, W, C, Cout, bias, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32) if bias else None
    return x, w, b


def _bf16_ulp(a):
    """One bfloat16 ulp at each value of a (8 significant bits)."""
    a = np.abs(a.astype(np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


# (B, H, W, C, Cout, block_rows): two and four row blocks (in interpret
# mode the kernel traces every halo branch, so one block cannot run), and
# channel counts ragged against the port kernel's 8-channel chunks and
# 64-channel tiles
CASES = [(1, 16, 16, 8, 8, 8), (2, 16, 12, 5, 9, 4), (1, 16, 8, 16, 70, 8)]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_pallas_interpret_f32(case, bias):
    B, H, W, C, Cout, br = case
    x, w, b = _inputs(B, H, W, C, Cout, bias, seed=sum(case))
    ref = np.asarray(_pallas_interpret(
        jnp.asarray(x), jnp.asarray(w),
        None if b is None else jnp.asarray(b), br))
    out = k3.conv3x3_nhwc_reference(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", CASES[:2], ids=lambda c: "x".join(
    map(str, c)))
def test_plain_matches_pallas_interpret_bf16(case):
    """bfloat16 x and weights, a float32 bias (added from its own dtype)."""
    B, H, W, C, Cout, br = case
    x, w, b = _inputs(B, H, W, C, Cout, True, seed=sum(case) + 1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    ref = np.asarray(_pallas_interpret(xb, wb, jnp.asarray(b), br)
                     .astype(jnp.float32))
    out = k3.conv3x3_nhwc_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), \
        np.abs(got - ref).max()


def test_weights_are_rounded_to_x_dtype():
    """float32 weights with bfloat16 x: rounded to bfloat16 first, as
    ``w.astype(x.dtype)`` does (pallas_conv.py:105)."""
    x, w, b = _inputs(1, 8, 8, 4, 6, True, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    got = k3.conv3x3_nhwc_reference(xb, torch.from_numpy(w),
                                    torch.from_numpy(b))
    want = k3.conv3x3_nhwc_reference(xb, torch.from_numpy(w).bfloat16(),
                                     torch.from_numpy(b))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 7, 9, 3, 5), (1, 13, 4, 10, 66)])
def test_any_h_matches_lax_conv(shape):
    """H that no block_rows of the TPU kernel divides: the port takes any
    H, W, C and Cout. Held against XLA's conv at the highest precision."""
    B, H, W, C, Cout = shape
    x, w, b = _inputs(B, H, W, C, Cout, True, seed=sum(shape))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    out = k3.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    x, w, b = _inputs(2, 6, 5, 4, 3, True, seed=9)
    k3.reset_launches()
    out = k3.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    ref = k3.conv3x3_nhwc_reference(torch.from_numpy(x),
                                    torch.from_numpy(w),
                                    torch.from_numpy(b))
    assert torch.equal(out, ref)
    assert k3.nhwc_launches == 0 and k3.launches == 0


def test_backward_raises():
    """conv3x3_pallas has no VJP: a backward through the port's
    counterpart raises, never a silent zero gradient."""
    x, w, b = _inputs(1, 4, 4, 2, 3, True, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    out = k3.conv3x3_nhwc(xt, torch.from_numpy(w), torch.from_numpy(b))
    with pytest.raises(NotImplementedError, match="no gradient"):
        out.sum().backward()
    assert xt.grad is None


def test_shape_checks():
    x = torch.zeros(1, 5, 5, 4)
    with pytest.raises(ValueError, match="input channels"):
        k3.conv3x3_nhwc(x, torch.zeros(3, 3, 5, 2))
    with pytest.raises(ValueError, match="3, 3, C, Cout"):
        k3.conv3x3_nhwc(x, torch.zeros(2, 4, 3, 3))
    with pytest.raises(ValueError, match="bias"):
        k3.conv3x3_nhwc(x, torch.zeros(3, 3, 4, 2), torch.zeros(3))
