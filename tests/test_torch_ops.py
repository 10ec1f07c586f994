"""The port's coordinate and resampling ops against their JAX counterparts
(synergize_motion_appearance_tpu/ops/coords.py and ops/interp.py), on the
same numpy inputs. The port is NCHW; the JAX ops are NHWC.

Tolerances: both sides compute in float32 with the same formulas; they
differ only in summation order (matmul vs conv vs gather), so values of
order 1 agree to 1e-5 and exactly-computed grids agree to 1e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops import coords as jc  # noqa: E402
from synergize_motion_appearance_tpu.ops import interp as ji  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import coords as tc  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import interp as ti  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("h,w", [(16, 16), (7, 12)])
def test_make_coordinate_grid(h, w):
    np.testing.assert_allclose(tc.make_coordinate_grid(h, w).numpy(),
                               np.asarray(jc.make_coordinate_grid(h, w)),
                               atol=1e-7, rtol=0)


def test_kp2gaussian():
    kp = np.tanh(_rand(2, 5, 2, seed=1))
    out = tc.kp2gaussian(torch.from_numpy(kp), (16, 12), 0.01).numpy()
    ref = np.asarray(jc.kp2gaussian(jnp.asarray(kp), (16, 12), 0.01))
    np.testing.assert_allclose(out, ref, **TOL)


def test_softargmax_kp():
    hm = np.exp(_rand(2, 5, 8, 8, seed=2))
    hm = hm / hm.sum(axis=(2, 3), keepdims=True)
    out = tc.softargmax_kp(torch.from_numpy(hm)).numpy()
    ref = np.asarray(jc.softargmax_kp(jnp.asarray(hm)))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("scale", [0.25, 0.5])
def test_antialias_downsample(scale):
    x = _rand(2, 32, 32, 3, seed=3)
    out = tc.antialias_downsample(_nchw(x), scale)
    ref = np.asarray(jc.antialias_downsample(jnp.asarray(x), scale))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_convex_hull_area(seed):
    pts = np.tanh(_rand(15, 2, seed=seed))
    out = float(tc.convex_hull_area(torch.from_numpy(pts)))
    ref = float(jc.convex_hull_area(jnp.asarray(pts)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("img_batch", [1, 3])
def test_grid_sample(align, img_batch):
    img = _rand(img_batch, 9, 11, 4, seed=7)
    grid = np.clip(_rand(3, 6, 5, 2, seed=8) * 0.8, -1.3, 1.3)
    out = ti.grid_sample(_nchw(img), torch.from_numpy(grid), align, "zeros")
    ref = np.asarray(ji.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                    align, "zeros"))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


@pytest.mark.parametrize("img_batch", [1, 2])
def test_grid_sample_grouped(img_batch):
    img = _rand(img_batch, 8, 8, 3, seed=9)
    grids = np.clip(_rand(2, 4, 8, 8, 2, seed=10) * 0.7, -1.2, 1.2)
    out = ti.grid_sample_grouped(_nchw(img), torch.from_numpy(grids))
    ref = np.asarray(ji.grid_sample_grouped(jnp.asarray(img),
                                            jnp.asarray(grids)))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape", [((8, 8), (16, 16)), ((16, 16), (8, 8)),
                                   ((13, 7), (5, 9))])
def test_resize_bilinear(align, shape):
    (H, W), (h, w) = shape
    x = _rand(2, H, W, 3, seed=11)
    out = ti.resize_bilinear(_nchw(x), (h, w), align)
    ref = np.asarray(ji.resize_bilinear(jnp.asarray(x), (h, w), align))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


@pytest.mark.parametrize("n_in,n_out", [(64, 16), (32, 8), (16, 16)])
def test_resize_tap_plan(n_in, n_out):
    idx, w = ti.resize_tap_plan(n_in, n_out)
    ridx, rw = ji.resize_tap_plan(n_in, n_out)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(w, rw)


def test_resize_bilinear_at_and_tap_reduce():
    x = _rand(2, 8, 8, 2, seed=12)
    ty, wy = ti.resize_tap_plan(32, 8)
    tx, wx = ti.resize_tap_plan(32, 8)
    out = ti.resize_bilinear_at(_nchw(x), (32, 32), ty, tx)
    ref = np.asarray(ji.resize_bilinear_at(jnp.asarray(x), (32, 32), ty, tx))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)
    taps = _rand(2, 16, 16, 3, seed=13)
    out = ti.tap_reduce(_nchw(taps), wy, wx)
    ref = np.asarray(ji.tap_reduce(jnp.asarray(taps), wy, wx))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


def test_interpolate_flow():
    flow = np.tanh(_rand(2, 8, 8, 2, seed=14))
    out = ti.interpolate_flow(torch.from_numpy(flow), (20, 20)).numpy()
    ref = np.asarray(ji.interpolate_flow(jnp.asarray(flow), (20, 20)))
    np.testing.assert_allclose(out, ref, **TOL)


def test_upsample_nearest_and_avg_pool():
    x = _rand(2, 6, 10, 3, seed=15)
    np.testing.assert_array_equal(
        _nhwc(ti.upsample_nearest(_nchw(x), 2)),
        np.asarray(ji.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_allclose(
        _nhwc(ti.avg_pool_2x(_nchw(x))),
        np.asarray(ji.avg_pool_2x(jnp.asarray(x))), **TOL)
