"""The port's models/arch_util.py against the JAX package's, on the CPU:
``flow_warp`` and ``resize_flow`` in every mode, ``ResidualBlockNoBN``,
``Upsample``, ``make_layer``, ``ModulatedDeformConvPack`` and
``DCNv2Pack`` on JAX parameters carried across by
``weights.block_state_dict``, and the two initializers.

Weights. The JAX trees come from ``jax.eval_shape`` of each module's init
(which compiles nothing), filled from a numpy seed (``random_variables``):
kernels normal over sqrt(fan-in), BatchNorm scales 1 + 0.1-normal and
running variances in [0.5, 1.5], the rest 0.1-normal, so the packs'
offset convs predict offsets of a few pixels. JAX runs un-jitted.

Tolerances (float32 on both sides): outputs within 1e-5 of the largest
magnitude, absolute and relative (other summation orders); the packs
within 1e-4 (a sampled tap moves with its offset, which is itself a
conv output). The initializers are held to their bounds and their
spread, within 15% of the JAX draw's standard deviation over 4096
values.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.models import (  # noqa: E402
    arch_util as jau,
)
from synergize_motion_appearance_tpu_torch import models, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    arch_util as au,
)

from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

TOL = 1e-5
PACK_TOL = 1e-4


def random_variables(shapes, seed):
    """A tree of numpy float32 arrays of the shapes of ``shapes`` (the
    output of ``jax.eval_shape``), filled by leaf name."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name in ("kernel", "weight", "v"):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "g"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    """NHWC (or NDHWC) numpy -> NCHW (NCDHW) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def carried(jax_module, port_module, *args, seed=0, **kw):
    """JAX variables for ``jax_module`` on ``args`` (arrays, or lists of
    them) and ``port_module`` loaded with them (strict)."""
    shapes = jax.eval_shape(functools.partial(jax_module.init, **kw),
                            jax.random.PRNGKey(0),
                            *(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else [jnp.asarray(b) for b in a]
                              for a in args))
    variables = random_variables(shapes, seed)
    port_module.load_state_dict(
        weights.block_state_dict(variables, port_module), strict=True)
    return variables


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("align", [True, False], ids=["align", "noalign"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp(mode, padding, align):
    x, flow = rand(2, 8, 10, 3, seed=1), rand(2, 8, 10, 2, seed=2,
                                               scale=2.5)
    want = jau.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode, padding,
                         align)
    got = au.flow_warp(nchw(x), torch.from_numpy(flow), mode, padding,
                       align)
    close(nhwc(got), want)


@pytest.mark.parametrize("align", [False, True], ids=["noalign", "align"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("size_type,sizes", [("ratio", (2.0, 1.5)),
                                             ("shape", (5, 7))])
def test_resize_flow(size_type, sizes, mode, align):
    flow = rand(2, 6, 8, 2, seed=3, scale=3)
    want = jau.resize_flow(jnp.asarray(flow), size_type, sizes, mode, align)
    got = au.resize_flow(torch.from_numpy(flow), size_type, sizes, mode,
                         align)
    assert got.shape == want.shape
    close(got.numpy(), want)


def test_resize_flow_bad_type():
    with pytest.raises(ValueError, match="ratio or shape"):
        au.resize_flow(torch.zeros(1, 4, 4, 2), "scale", (2, 2))


@pytest.mark.parametrize("res_scale", [1.0, 0.5])
def test_residual_block_no_bn(res_scale):
    x = rand(2, 6, 5, 8, seed=4)
    jm = jau.ResidualBlockNoBN(num_feat=8, res_scale=res_scale)
    pm = au.ResidualBlockNoBN(num_feat=8, res_scale=res_scale)
    v = carried(jm, pm, x, seed=5)
    close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upsample(scale):
    x = rand(1, 4, 5, 6, seed=6)
    jm, pm = jau.Upsample(scale=scale, num_feat=6), au.Upsample(scale, 6)
    v = carried(jm, pm, x, seed=7)
    got = pm(nchw(x))
    assert got.shape == (1, 6, 4 * scale, 5 * scale)
    close(nhwc(got), jm.apply(v, jnp.asarray(x)))


def test_upsample_bad_scale():
    with pytest.raises(ValueError, match="scale 5"):
        au.Upsample(5, 8)


def test_make_layer():
    x = rand(1, 5, 5, 8, seed=8)
    jm = jau.make_layer(jau.ResidualBlockNoBN, 3, num_feat=8)
    pm = au.make_layer(au.ResidualBlockNoBN, 3, num_feat=8)
    assert [n for n, _ in pm.named_children()] == ["0", "1", "2"]
    v = carried(jm, pm, x, seed=9)
    assert set(v["params"]) == {"block0", "block1", "block2"}
    close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x)))


PACKS = {  # (in, out, stride, groups, deformable_groups)
    "plain": (8, 12, 1, 1, 1),
    "dg2_groups2": (8, 6, 1, 2, 2),
    "stride2_dg4": (8, 4, 2, 1, 4),
}


@pytest.mark.parametrize("case", sorted(PACKS))
@pytest.mark.parametrize("kind", ["ModulatedDeformConvPack", "DCNv2Pack"])
def test_dcn_packs(kind, case):
    cin, cout, s, groups, dg = PACKS[case]
    x, feat = rand(2, 7, 6, cin, seed=10), rand(2, 7, 6, cin, seed=11)
    jm = getattr(jau, kind)(features=cout, stride=(s, s), groups=groups,
                            deformable_groups=dg)
    pm = getattr(au, kind)(cin, cout, stride=s, groups=groups,
                           deformable_groups=dg)
    args = (x,) if kind == "ModulatedDeformConvPack" else (x, feat)
    v = carried(jm, pm, *args, seed=12)
    assert sorted(pm.state_dict()) == ["bias", "conv_offset.bias",
                                       "conv_offset.weight", "weight"]
    close(nhwc(pm(*(nchw(a) for a in args))),
          jm.apply(v, *(jnp.asarray(a) for a in args)), PACK_TOL)


def test_pack_at_init_is_half_conv():
    """conv_offset starts at 0: offsets 0 and the mask sigmoid(0) = 0.5,
    so the pack is 0.5 conv + bias, as BasicSR's is at init."""
    torch.manual_seed(0)
    pm = au.DCNv2Pack(8, 12)
    x, feat = torch.randn(2, 8, 7, 7), torch.randn(2, 8, 7, 7)
    with torch.no_grad():
        pm.bias.normal_()
        want = 0.5 * torch.nn.functional.conv2d(x, pm.weight, padding=1) \
            + pm.bias.view(1, -1, 1, 1)
        torch.testing.assert_close(pm(x, feat), want, rtol=1e-5, atol=1e-5)


def test_scaled_conv_kernel_init():
    """torch's default (kaiming uniform, a = sqrt(5)) times the scale, as
    the JAX initializer draws it; biases filled; repeatable from a
    generator."""
    conv = torch.nn.Conv2d(16, 64, 3)
    au.scaled_conv_kernel_init(conv, 0.1, bias_fill=0.25,
                               generator=torch.Generator().manual_seed(1))
    bound = 0.1 / math.sqrt(16 * 9)
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    jw = np.asarray(jau.scaled_conv_kernel_init(0.1)(
        jax.random.PRNGKey(0), (3, 3, 16, 64)))
    assert abs(w.std() / jw.std() - 1) < 0.15
    assert torch.all(conv.bias == 0.25)
    again = torch.nn.Conv2d(16, 64, 3)
    au.scaled_conv_kernel_init(again, 0.1, bias_fill=0.25,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(again.weight, conv.weight)
    block = au.ResidualBlockNoBN(num_feat=16)
    assert block.conv1.weight.abs().max() <= 0.1 / math.sqrt(16 * 9)


@pytest.mark.parametrize("std,mean,a,b", [(0.02, 0.0, -2.0, 2.0),
                                          (1.0, 0.5, -1.0, 3.0)])
def test_trunc_normal_init(std, mean, a, b):
    """Bounds mean + [a, b] std, and the JAX draw's spread."""
    w = au.trunc_normal_init(torch.empty(4096), std, mean, a, b,
                             generator=torch.Generator().manual_seed(2))
    jw = np.asarray(jau.trunc_normal_init(std, mean, a, b)(
        jax.random.PRNGKey(0), (4096,)))
    w = w.numpy()
    for arr in (w, jw):
        assert arr.min() >= mean + a * std - 1e-6
        assert arr.max() <= mean + b * std + 1e-6
    assert abs(w.std() / jw.std() - 1) < 0.15
    assert abs(w.mean() - jw.mean()) < 0.15 * jw.std()


def test_models_export_the_jax_names():
    """models/__init__ exports what the JAX package's does at :27-37."""
    for name in ("DCNv2Pack", "ModulatedDeformConvPack",
                 "ResidualBlockNoBN", "Upsample", "flow_warp", "make_layer",
                 "resize_flow", "scaled_conv_kernel_init",
                 "trunc_normal_init"):
        assert getattr(models, name) is getattr(au, name)
