"""The port's deformable convolutions, StyleGAN2 ops and ``resize_nearest``
against the JAX package's, on the CPU (modelled on
tests/test_native_ops.py): the same numpy inputs in NHWC for JAX and
NCHW for the port.

Tolerances (float32 on both sides): outputs within 1e-5 of the largest
output magnitude, absolute and relative (the frameworks sum the taps and
channels in other orders); the gradients of ``modulated_deform_conv2d``
(input, offset, mask, weight, bias) against ``jax.grad`` within 1e-4 of
each gradient's largest entry; ``resize_nearest`` and
``make_resample_kernel`` exactly. Offsets are drawn with scale 2.5, so
many taps fall partly or wholly outside the image, where the sample
reads 0; no sample lies on a pixel corner, where the bilinear weights'
derivative jumps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops import dcn as jdcn  # noqa: E402
from synergize_motion_appearance_tpu.ops import (  # noqa: E402
    stylegan_ops as jsg,
)
from synergize_motion_appearance_tpu.ops.interp import (  # noqa: E402
    resize_nearest as jresize_nearest,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    deform_conv2d, fused_leaky_relu, make_resample_kernel,
    modulated_deform_conv2d, resize_nearest, upfirdn2d,
)
from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

TOL = 1e-5
GRAD_TOL = 1e-4

# (B, H, W, Cin, Cout, k, stride, padding, dilation, groups, dg)
DCN_CASES = {
    "plain": (1, 6, 5, 4, 3, 3, 1, 1, 1, 1, 1),
    "stride2_dg2": (2, 9, 8, 4, 6, 3, 2, 1, 1, 1, 2),
    "dilation2": (1, 10, 9, 6, 4, 3, 1, 2, 2, 1, 3),
    "groups2_dg2": (2, 7, 7, 8, 6, 3, 1, 1, 1, 2, 2),
    "k1x1_groups3": (1, 5, 6, 6, 3, 1, 1, 0, 1, 3, 2),
    "pad0_k2": (1, 6, 7, 4, 4, 2, 1, 0, 1, 1, 1),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _dcn_inputs(case, seed):
    B, H, W, Cin, Cout, k, s, p, d, groups, dg = DCN_CASES[case]
    Ho = (H + 2 * p - (d * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * p - (d * (k - 1) + 1)) // s + 1
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        "x": rng.randn(B, H, W, Cin).astype(f32),
        "weight": (rng.randn(k, k, Cin // groups, Cout) * 0.3).astype(f32),
        "bias": (0.1 * rng.randn(Cout)).astype(f32),
        "offset": (2.5 * rng.randn(B, Ho, Wo, dg * k * k * 2)).astype(f32),
        "mask": rng.rand(B, Ho, Wo, dg * k * k).astype(f32),
        "kw": dict(stride=(s, s), padding=(p, p), dilation=(d, d),
                   groups=groups, deformable_groups=dg)}


def _jax_dcn(inp, mask):
    kw = inp["kw"]
    args = [jnp.asarray(inp[k]) for k in ("x", "offset")]
    if mask:
        return jdcn.modulated_deform_conv2d(
            *args, jnp.asarray(inp["mask"]), jnp.asarray(inp["weight"]),
            jnp.asarray(inp["bias"]), **kw)
    return jdcn.deform_conv2d(*args, jnp.asarray(inp["weight"]),
                              jnp.asarray(inp["bias"]), **kw)


def _port_args(inp):
    """The port's NCHW tensors; the weight HWIO -> OIHW."""
    return {"x": _nchw(inp["x"]), "offset": _nchw(inp["offset"]),
            "mask": _nchw(inp["mask"]),
            "weight": torch.from_numpy(np.ascontiguousarray(
                inp["weight"].transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(inp["bias"])}


@pytest.mark.parametrize("mask", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv_matches_jax(case, mask):
    inp = _dcn_inputs(case, seed=len(case))
    want = np.asarray(_jax_dcn(inp, mask))
    t = _port_args(inp)
    if mask:
        got = modulated_deform_conv2d(t["x"], t["offset"], t["mask"],
                                      t["weight"], t["bias"], **inp["kw"])
    else:
        got = deform_conv2d(t["x"], t["offset"], t["weight"], t["bias"],
                            **inp["kw"])
    assert got.shape == _nchw(want).shape
    _close(_nhwc(got), want)


def test_offsets_reach_outside_the_image():
    """The draws put whole taps outside the image (they read 0) and
    partial ones across its edge."""
    B, H, W, Cin, Cout, k, s, p, d, groups, dg = DCN_CASES["stride2_dg2"]
    inp = _dcn_inputs("stride2_dg2", seed=len("stride2_dg2"))
    off = inp["offset"].reshape(B, -1, dg, k, k, 2)
    ys = off[..., 0] + np.arange(k)[None, None, None, :, None] * d - p
    assert (ys < -1).any() and ((ys > -1) & (ys < 0)).any()


@pytest.mark.parametrize("case", ["stride2_dg2", "groups2_dg2"])
def test_modulated_deform_conv_gradient_matches_jax(case):
    inp = _dcn_inputs(case, seed=7)
    names = ("x", "offset", "mask", "weight", "bias")
    rng = np.random.RandomState(8)
    out_shape = np.asarray(_jax_dcn(inp, True)).shape
    cot = rng.randn(*out_shape).astype(np.float32)

    def loss(x, offset, mask, weight, bias):
        y = jdcn.modulated_deform_conv2d(x, offset, mask, weight, bias,
                                         **inp["kw"])
        return jnp.sum(y * cot)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(inp[n]) for n in names))
    t = {k: v.requires_grad_() for k, v in _port_args(inp).items()}
    y = modulated_deform_conv2d(t["x"], t["offset"], t["mask"], t["weight"],
                                t["bias"], **inp["kw"])
    (y * _nchw(cot)).sum().backward()
    for n, w in zip(names, want):
        w = np.asarray(w)
        g = t[n].grad.numpy()
        if n == "weight":
            g = g.transpose(2, 3, 1, 0)
        elif n != "bias":
            g = np.moveaxis(g, 1, -1)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("slope,scale", [(0.2, 2 ** 0.5), (0.1, 1.0)])
def test_fused_leaky_relu(with_bias, slope, scale):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32) if with_bias else None
    want = jsg.fused_leaky_relu(jnp.asarray(x),
                                None if b is None else jnp.asarray(b),
                                slope, scale)
    got = fused_leaky_relu(_nchw(x), None if b is None else
                           torch.from_numpy(b), slope, scale)
    _close(_nhwc(got), np.asarray(want))


UPFIRDN = [  # (kernel taps, up, down, pad)
    ([1, 3, 3, 1], 2, 1, (2, 1)),
    ([1, 3, 3, 1], 1, 2, (1, 1)),
    ([1, 3, 3, 1], 2, 2, (1, 2)),
    ([1, 2, 1], 1, 1, (-1, 2)),
    ([1, 3, 3, 1], 2, 1, (-1, -2)),
    ([[1, 2, 0], [0, 1, 3], [2, 0, 1]], 1, 1, (1, 1)),  # asymmetric: flip
]


@pytest.mark.parametrize("taps,up,down,pad", UPFIRDN,
                         ids=[f"case{i}" for i in range(len(UPFIRDN))])
def test_upfirdn2d_matches_jax(taps, up, down, pad):
    x = np.random.RandomState(2).randn(2, 9, 8, 3).astype(np.float32)
    k_np = np.asarray(jsg.make_resample_kernel(taps))
    want = np.asarray(jsg.upfirdn2d(jnp.asarray(x), jnp.asarray(k_np), up,
                                    down, pad))
    got = upfirdn2d(_nchw(x), make_resample_kernel(taps), up, down, pad)
    assert got.shape == _nchw(want).shape
    _close(_nhwc(got), want)


@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 2, 1],
                                  [[1, 2], [3, 4]]])
def test_make_resample_kernel(taps):
    np.testing.assert_array_equal(make_resample_kernel(taps).numpy(),
                                  np.asarray(jsg.make_resample_kernel(taps)))


@pytest.mark.parametrize("out_hw", [(7, 5), (16, 12), (6, 9), (8, 8)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jresize_nearest(jnp.asarray(x), out_hw))
    got = resize_nearest(_nchw(x), out_hw)
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(_nhwc(torch.nn.functional.interpolate(
        _nchw(x), size=out_hw, mode="nearest")), want)


def test_resize_nearest_same_size_is_identity():
    x = torch.randn(1, 2, 5, 5)
    assert resize_nearest(x, (5, 5)) is x
