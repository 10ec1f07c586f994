"""The port's models/extended_blocks.py against the JAX package's, on the
CPU: every block on JAX parameters carried across by
``weights.block_state_dict`` (BatchNorm blocks in eval mode and in train
mode, with the running statistics after the train-mode call), and every
function.

The weights are ``jax.eval_shape`` trees filled from a numpy seed, as in
tests/test_torch_arch_util.py; JAX runs un-jitted. The JAX
tests/test_extended_blocks.py is in the slow tier, so each block runs at
the smallest widths that still take every branch (a learned and an
identity shortcut, stride 1 and 2) and ``KPHourglass`` at depth 2.

Tolerances (float32 on both sides): outputs and statistics within 1e-5
of the largest magnitude, absolute and relative (other summation
orders); the TPS solve within 1e-4 (a 8x8 system in float32); the
sinusoidal tables exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.models import (  # noqa: E402
    extended_blocks as jeb,
)
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    extended_blocks as eb,
)

from test_torch_arch_util import (  # noqa: E402
    carried, close, nchw, nhwc, rand,
)
from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

SOLVE_TOL = 1e-4


def _to_nhwc(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_to_nhwc(o) for o in out)
    return nhwc(out)


def _check(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w)
    else:
        assert got.shape == np.asarray(want).shape
        close(got, want)


def _bn_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_stats(port_module, new_vars, variables):
    """The JAX batch_stats after a train-mode call, in the port's names."""
    from synergize_motion_appearance_tpu_torch import weights

    sd = weights.block_state_dict({"params": variables["params"],
                                   "batch_stats": new_vars["batch_stats"]},
                                  port_module)
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def run_block(jm, pm, args, port_args=None, train=None, seed=0):
    """The JAX module and the port's on the same weights and inputs;
    ``train`` None for a block without BatchNorm, else its mode."""
    kw = {} if train is None else {"train": train}
    v = carried(jm, pm, *args, seed=seed, **kw)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray)
             else [jnp.asarray(b) for b in a] for a in args]
    port_args = port_args or [nchw(a) for a in args]
    pm.train(bool(train))
    if train:
        want, new_vars = jm.apply(v, *jargs, train=True,
                                  mutable=["batch_stats"])
        got = pm(*port_args)
        stats = _bn_stats(pm)
        for k, w in _jax_stats(pm, new_vars, v).items():
            close(stats[k].numpy(), w.numpy())
    else:
        want = jm.apply(v, *jargs, **kw)
        got = pm(*port_args)
    with torch.no_grad():
        _check(_to_nhwc(got), want)


def test_wn_conv2d():
    x = rand(2, 6, 5, 4, seed=1)
    pm = eb.WNConv2d(4, 6, kernel_size=(3, 3), padding=1, groups=2)
    run_block(jeb.WNConv2d(6, groups=2), pm, [x], seed=2)
    assert sorted(pm.state_dict()) == ["bias", "weight_g", "weight_v"]


def test_wn_conv2d_starts_as_the_plain_conv():
    pm = eb.WNConv2d(3, 5)
    torch.testing.assert_close(pm.weight(), pm.weight_v.detach(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["WNResBlock2d", "WNDownBlock2d",
                                  "WNSameBlock2d"])
def test_wn_blocks(name):
    x = rand(2, 6, 6, 4, seed=3)
    jm = getattr(jeb, name)(4)
    pm = (eb.WNResBlock2d(4) if name == "WNResBlock2d"
          else getattr(eb, name)(4, 4))
    run_block(jm, pm, [x], seed=4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_wn_up_block(train):
    run_block(jeb.WNUpBlock2d(5), eb.WNUpBlock2d(3, 5),
              [rand(2, 4, 5, 3, seed=5)], train=train, seed=6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stride,cin", [(1, 8), (2, 4)])
def test_res_bottleneck(stride, cin, train):
    run_block(jeb.ResBottleneck(8, stride=stride),
              eb.ResBottleneck(cin, 8, stride=stride),
              [rand(2, 6, 6, cin, seed=7)], train=train, seed=8)


@pytest.mark.parametrize("factor", [2, 3])
def test_pixel_shuffle_and_unshuffle(factor):
    x = rand(2, 4, 5, 2 * factor * factor, seed=9)
    up = eb.pixel_shuffle(nchw(x), factor)
    close(nhwc(up), jeb.pixel_shuffle(jnp.asarray(x), factor))
    y = rand(2, 3 * factor, 2 * factor, 5, seed=10)
    down = eb.pixel_unshuffle(nchw(y), factor)
    close(nhwc(down), jeb.pixel_unshuffle(jnp.asarray(y), factor))
    assert torch.equal(eb.pixel_unshuffle(up, factor), nchw(x))


def test_pixel_shuffle_blocks():
    x = rand(2, 4, 4, 8, seed=11)
    run_block(jeb.PixelShuffleUpsample(2), eb.PixelShuffleUpsample(8, 2),
              [x], seed=12)
    run_block(jeb.PixelUnshuffleDownsample(2),
              eb.PixelUnshuffleDownsample(8, 2), [x], seed=13)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sub_pixel_up_block(train):
    run_block(jeb.SubPixelUpBlock2d(6), eb.SubPixelUpBlock2d(4, 6),
              [rand(2, 4, 4, 4, seed=14)], train=train, seed=15)


BE, IN, NB, MAXF = 4, 3, 2, 16  # hourglass widths: 3 -> 8 -> 16 channels


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_w_emb(train):
    skips = [rand(2, 16, 16, IN, seed=16), rand(2, 8, 8, 8, seed=17),
             rand(2, 4, 4, 16, seed=18)]
    pm = eb.DecoderWEmb(BE, IN, NB, MAXF)
    run_block(jeb.DecoderWEmb(BE, IN, NB, MAXF), pm, [skips],
              port_args=[[nchw(s) for s in skips]], train=train, seed=19)


@pytest.mark.parametrize("name", ["Hourglass2Branch", "HourglassWEmb"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hourglass_variants(name, train):
    run_block(getattr(jeb, name)(BE, IN, NB, MAXF),
              getattr(eb, name)(BE, IN, NB, MAXF),
              [rand(2, 16, 16, IN, seed=20)], train=train, seed=21)


@pytest.mark.parametrize("seg_hw", [(8, 8), (3, 5)])
def test_spade(seg_hw):
    x, seg = rand(2, 6, 6, 4, seed=22, scale=2), rand(2, *seg_hw, 3,
                                                     seed=23)
    run_block(jeb.SPADE(4, 3), eb.SPADE(4, 3), [x, seg], seed=24)


@pytest.mark.parametrize("fin,fout", [(4, 6), (5, 5)],
                         ids=["learned_shortcut", "identity_shortcut"])
def test_spade_resnet_block(fin, fout):
    x, seg = rand(2, 6, 6, fin, seed=25), rand(2, 12, 12, 3, seed=26)
    pm = eb.SPADEResnetBlock(fin, fout, 3)
    run_block(jeb.SPADEResnetBlock(fin, fout, 3), pm, [x, seg], seed=27)
    assert hasattr(pm, "conv_s") == (fin != fout)


def test_make_coordinate_grid_3d():
    close(eb.make_coordinate_grid_3d(3, 4, 5).numpy(),
          jeb.make_coordinate_grid_3d(3, 4, 5))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_up_block_3d(train):
    x = rand(2, 3, 4, 5, 4, seed=28)  # (B, D, H, W, C)
    run_block(jeb.UpBlock3d(6), eb.UpBlock3d(4, 6), [x], train=train,
              seed=29)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_kp_hourglass(train):
    jm = jeb.KPHourglass(4, 3, reshape_features=16, reshape_depth=4,
                         num_blocks=2, max_features=16)
    pm = eb.KPHourglass(4, 3, reshape_features=16, reshape_depth=4,
                        num_blocks=2, max_features=16)
    x = rand(2, 16, 16, 3, seed=30)
    run_block(jm, pm, [x], train=train, seed=31)


def _head_pose(seed, jacobian=True, exp_jacobian=True):
    rng = np.random.RandomState(seed)
    B, K = 2, 5
    kp = {"value": rng.randn(B, K, 3).astype(np.float32),
          "jacobian": (rng.randn(B, K, 3, 3).astype(np.float32)
                       if jacobian else None)}
    he = {k: rng.randn(B, 66).astype(np.float32)
          for k in ("yaw", "pitch", "roll")}
    he["t"] = rng.randn(B, 3).astype(np.float32)
    he["exp"] = rng.randn(B, 3 * K).astype(np.float32)
    if exp_jacobian:
        he["exp_jacobian"] = rng.randn(B, 9 * K).astype(np.float32)
    return kp, he


def _j(tree):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in tree.items()}


def _t(tree):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in tree.items()}


def test_head_pose_math():
    _, he = _head_pose(32)
    deg = eb.headpose_pred_to_degree(torch.from_numpy(he["yaw"]))
    close(deg.numpy(), jeb.headpose_pred_to_degree(jnp.asarray(he["yaw"])))
    angles = [np.random.RandomState(33 + i).uniform(-90, 90, 3)
              .astype(np.float32) for i in range(3)]
    close(eb.get_rotation_matrix(*map(torch.from_numpy, angles)).numpy(),
          jeb.get_rotation_matrix(*map(jnp.asarray, angles)))


@pytest.mark.parametrize("jacobian,exp_jacobian", [
    (True, True), (True, False), (False, False)])
def test_keypoint_transformation(jacobian, exp_jacobian):
    kp, he = _head_pose(34, jacobian, exp_jacobian)
    want = jeb.keypoint_transformation(_j(kp), _j(he))
    got = eb.keypoint_transformation(_t(kp), _t(he))
    close(got["value"].numpy(), want["value"])
    assert (got["jacobian"] is None) == (want["jacobian"] is None)
    if jacobian:
        close(got["jacobian"].numpy(), want["jacobian"])


def test_tps_kp_params_and_warp():
    rng = np.random.RandomState(35)
    kp1 = rng.uniform(-1, 1, (2, 3, 5, 2)).astype(np.float32)
    kp2 = (kp1 + 0.1 * rng.randn(*kp1.shape)).astype(np.float32)
    coords = rng.uniform(-1, 1, (2, 7, 2)).astype(np.float32)
    want = jeb.tps_kp_params(jnp.asarray(kp1), jnp.asarray(kp2))
    got = eb.tps_kp_params(torch.from_numpy(kp1), torch.from_numpy(kp2))
    for g, w in zip(got, want):
        close(g.numpy(), w, SOLVE_TOL)
    close(eb.tps_kp_warp(*got, torch.from_numpy(coords)).numpy(),
          jeb.tps_kp_warp(*want, jnp.asarray(coords)), SOLVE_TOL)


@pytest.mark.parametrize("padding_idx,div_half_dim", [
    (None, False), (0, False), (2, True)])
def test_sinusoidal_embedding(padding_idx, div_half_dim):
    got = eb.sinusoidal_embedding(9, 8, padding_idx, div_half_dim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), jeb.sinusoidal_embedding(9, 8, padding_idx,
                                              div_half_dim))


@pytest.mark.parametrize("hw", [(4, 6), (5, 3)])
def test_sinusoidal_grid_2d(hw):
    np.testing.assert_array_equal(eb.sinusoidal_grid_2d(*hw, 8).numpy(),
                                  jeb.sinusoidal_grid_2d(*hw, 8))
