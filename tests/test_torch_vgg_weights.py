"""``train.vgg_weights`` in the port's ``Trainer``, on the CPU: the tiny
training config (options/tiny_train.yml) with the key pointing at a
random ``VGG19Features`` tree written by tools/convert_vgg_weights.py's
``save_npz`` (or the port's own VGG19Features state_dict in a torch file)
trains against that VGG: its weights equal the file's bit for bit, and
the port's ``MultiScalePyramidPerceptualLoss`` over it equals, within
1e-5 relative, the JAX loss applied to the file's params (jitted once).
An absent file and a tree other than VGG19Features' raise and name the
path.
"""
import sys
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))

from convert_vgg_weights import load_npz, save_npz  # noqa: E402

from synergize_motion_appearance_tpu.losses import losses as jl  # noqa: E402
from synergize_motion_appearance_tpu.models import (  # noqa: E402
    VGG19Features as JaxVGG19Features,
)
from synergize_motion_appearance_tpu_torch import configs, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.training import Trainer  # noqa: E402

from test_torch_vqgan_extras import (  # noqa: E402,F401
    random_params,
    two_torch_threads,
)


@pytest.fixture(scope="module")
def vgg_file(tmp_path_factory):
    """A random VGG19Features tree as tools/convert_vgg_weights.py
    writes it."""
    jm = JaxVGG19Features()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    save_npz(random_params(shapes["params"], 0), path)
    return path


def _trainer(path):
    opt = configs.get("tiny_train")
    opt["train"]["vgg_weights"] = path
    return Trainer(opt, device="cpu", seed=0)


def _frames(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)


def test_trainer_loads_npz_and_matches_jax_loss(vgg_file):
    tr = _trainer(vgg_file)
    params = load_npz(vgg_file)
    want_sd = weights.vgg_state_dict(params)
    got_sd = tr.vgg.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    pred, target = _frames(1), _frames(2)
    scales = tr.cri_perceptual.scales
    jloss = jl.MultiScalePyramidPerceptualLoss(
        lambda p, x: JaxVGG19Features().apply({"params": p}, x),
        scales=scales)
    want = float(jax.jit(jloss)(params, jnp.asarray(pred),
                                jnp.asarray(target)))

    def nchw(a):
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    with torch.no_grad():
        got = float(tr.cri_perceptual(tr.vgg, nchw(pred), nchw(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the random VGG that the key replaces gives another loss
    with torch.no_grad():
        seeded = float(tr.cri_perceptual(_trainer(None).vgg, nchw(pred),
                                         nchw(target)))
    assert abs(seeded - want) > 1e-3 * abs(want)


def test_trainer_loads_torch_file(vgg_file, tmp_path):
    sd = weights.vgg_state_dict(load_npz(vgg_file))
    path = str(tmp_path / "vgg19.pth")
    torch.save(sd, path)
    got = _trainer(path).vgg.state_dict()
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_absent_file_raises(tmp_path):
    path = str(tmp_path / "missing.npz")
    with pytest.raises(RuntimeError, match="vgg_weights") as e:
        _trainer(path)
    assert path in str(e.value)


@pytest.mark.parametrize("change", ["drop_conv12", "extra_conv13",
                                    "wrong_shape"])
def test_mismatched_tree_raises(vgg_file, tmp_path, change):
    params = load_npz(vgg_file)
    if change == "drop_conv12":
        del params["conv12"]
    elif change == "extra_conv13":
        params["conv13"] = params["conv12"]
    else:
        params["conv3"]["Conv_0"]["bias"] = np.zeros(7, np.float32)
    path = str(tmp_path / f"{change}.npz")
    save_npz(params, path)
    with pytest.raises(ValueError, match="vgg_weights") as e:
        _trainer(path)
    assert path in str(e.value)
