"""The port's loss registry, losses and gradient penalties against the JAX
package's losses/losses.py, on the CPU.

- The registry holds the JAX registry's 13 names, and ``build_loss``
  builds each from a JAX-style option dict (LPIPSLoss on seeded LPIPS
  weights written to a temporary file).
- ``L1Loss``, ``MSELoss`` and ``CharbonnierLoss`` with each reduction
  (``none`` returns the elementwise loss) and without a weight map, with
  a 1-channel map (a weighted mean over the map's mass times C) and with
  a 3-channel one; ``WeightedL1Loss``, ``WeightedTVLoss``,
  ``TPSM_EquivarianceLoss`` and ``TPSM_BGLoss``; ``PerceptualLoss`` with
  each criterion, with the style term, with ``range_norm`` and with an
  unknown layer name, over ``VGG19Features`` at 32x32 on random weights
  carried across by ``weights.vgg_state_dict`` (the JAX VGG is this
  file's one jitted network).
- ``r1_penalty``, ``gradient_penalty_loss`` (with and without a weight
  map) and ``g_path_regularize`` over a small linear + LeakyReLU
  discriminator (a linear + tanh generator for the path length), the same
  weights on both sides; the draw JAX takes from its key (WGAN-GP's blend
  weights, the path-length noise) is patched into the port's draw. Each
  penalty's gradient to the networks' weights (a double backward on the
  port's side) is held as well.

Bounds: 1e-5 relative, 1e-6 absolute where the value is 0 (float32 on
both sides; the sums run in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu import ops as jops  # noqa: E402
from synergize_motion_appearance_tpu.losses import losses as jl  # noqa: E402
from synergize_motion_appearance_tpu.metrics import (  # noqa: E402
    external as jext,
    lpips_jax as jlp,
)
from synergize_motion_appearance_tpu.models import (  # noqa: E402
    VGG19Features as JaxVGG19Features,
)
from synergize_motion_appearance_tpu.utils.registry import (  # noqa: E402
    LOSS_REGISTRY as JAX_LOSS_REGISTRY,
)
from synergize_motion_appearance_tpu_torch import losses as tl  # noqa: E402
from synergize_motion_appearance_tpu_torch import ops as tops  # noqa: E402
from synergize_motion_appearance_tpu_torch import weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.metrics import lpips  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    VGG19Features,
)
from synergize_motion_appearance_tpu_torch.utils.registry import (  # noqa: E402
    LOSS_REGISTRY,
)

from test_torch_vqgan_extras import (  # noqa: E402,F401
    random_params,
    two_torch_threads,
)

REL, ABS = 1e-5, 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want):
    """``got`` (torch, NCHW where 4-D) against ``want`` (JAX, NHWC)."""
    want = np.asarray(want, np.float64)
    got = got.detach() if isinstance(got, torch.Tensor) else torch.tensor(got)
    got = got.double().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=ABS)


def _arr(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

BUILD_OPTS = {
    "L1Loss": dict(loss_weight=1.0, reduction="mean"),
    "MSELoss": dict(loss_weight=0.5, reduction="sum"),
    "CharbonnierLoss": dict(loss_weight=1.0, eps=1e-6),
    "WeightedL1Loss": dict(gamma=0.8),
    "WeightedTVLoss": dict(loss_weight=2.0),
    "GANLoss": dict(gan_type="hinge", loss_weight=0.1),
    "MultiScalePyramidPerceptualLoss": dict(
        scales=[1, 0.5], num_channels=3, loss_weights=[1.0] * 5),
    "PerceptualLoss": dict(layer_weights={"conv5_4": 1.0},
                           perceptual_weight=1.0, style_weight=0.0,
                           criterion="l1"),
    "LPIPSLoss": dict(loss_weight=1.0, use_input_norm=True),
    "TPSM_EquivarianceLoss": dict(loss_weight=10.0),
    "TPSM_BGLoss": dict(loss_weight=10.0),
    "EquivarianceLoss": dict(loss_weight_value=10, loss_weight_jacobian=10,
                             transform_params={"sigma_affine": 0.05}),
    "KPDistanceLoss": dict(loss_weight=1.0),
}


def test_registry_holds_the_jax_names():
    assert sorted(LOSS_REGISTRY.keys()) == sorted(JAX_LOSS_REGISTRY.keys())
    assert len(LOSS_REGISTRY.keys()) == 13
    assert set(BUILD_OPTS) == set(LOSS_REGISTRY.keys())


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    sd = lpips.LPIPSVgg().state_dict()
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    np.savez(path, **jext.flatten_params(jlp.convert_lpips_weights(sd, sd)))
    return str(path)


@pytest.mark.parametrize("name", sorted(BUILD_OPTS))
def test_build_loss_builds_each(name, lpips_weights, monkeypatch):
    monkeypatch.setenv("SAMT_LPIPS_WEIGHTS", lpips_weights)
    loss = tl.build_loss({"type": name, **BUILD_OPTS[name]})
    assert type(loss) is LOSS_REGISTRY.get(name)
    assert type(loss).__name__ == JAX_LOSS_REGISTRY.get(name).__name__


def test_build_loss_unknown_type_lists_names():
    with pytest.raises(KeyError, match="L1Loss"):
        tl.build_loss({"type": "NoSuchLoss"})


# ---------------------------------------------------------------------------
# pixel losses with weight maps and reductions
# ---------------------------------------------------------------------------

def _weight(kind, shape, seed):
    if kind is None:
        return None
    b, h, w, c = shape
    return _arr((b, h, w, 1 if kind == "map1" else c), seed, 0.0, 1.0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weight", [None, "map1", "map3"])
@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "CharbonnierLoss"])
def test_pixel_losses_match_jax(name, weight, reduction):
    shape = (2, 8, 8, 3)
    pred, target = _arr(shape, 0), _arr(shape, 1)
    wmap = _weight(weight, shape, 2)
    opts = dict(loss_weight=0.7, reduction=reduction)
    want = getattr(jl, name)(**opts)(
        jnp.asarray(pred), jnp.asarray(target),
        None if wmap is None else jnp.asarray(wmap))
    got = tl.build_loss({"type": name, **opts})(
        _nchw(pred), _nchw(target), None if wmap is None else _nchw(wmap))
    _close(got, want)


@pytest.mark.parametrize("weight", [None, "map1"])
def test_weighted_l1_loss_matches_jax(weight):
    shape = (2, 8, 8, 3)
    preds = [_arr(shape, 10 + i) for i in range(3)]
    targets = [_arr(shape, 20 + i) for i in range(3)]
    wmap = _weight(weight, shape, 3)
    want = jl.WeightedL1Loss(gamma=0.8)(
        [jnp.asarray(p) for p in preds], [jnp.asarray(t) for t in targets],
        None if wmap is None else jnp.asarray(wmap))
    got = tl.WeightedL1Loss(gamma=0.8)(
        [_nchw(p) for p in preds], [_nchw(t) for t in targets],
        None if wmap is None else _nchw(wmap))
    _close(got, want)


@pytest.mark.parametrize("weight", [None, "map1", "map3"])
def test_weighted_tv_loss_matches_jax(weight):
    shape = (2, 9, 7, 3)
    pred = _arr(shape, 4)
    wmap = _weight(weight, shape, 5)
    want = jl.WeightedTVLoss(loss_weight=1.5)(
        jnp.asarray(pred), None if wmap is None else jnp.asarray(wmap))
    got = tl.WeightedTVLoss(loss_weight=1.5)(
        _nchw(pred), None if wmap is None else _nchw(wmap))
    _close(got, want)


# ---------------------------------------------------------------------------
# the TPS-motion-model losses
# ---------------------------------------------------------------------------

def test_tpsm_equivariance_loss_matches_jax():
    p = jops.sample_random_tps(jax.random.PRNGKey(1), 2, 0.05, 0.005, 5)
    tp = tops.RandomTPSParams(*(torch.from_numpy(np.array(a)) for a in p))
    kp_d, kp_t = _arr((2, 10, 2), 6), _arr((2, 10, 2), 7)
    want = jl.TPSM_EquivarianceLoss(loss_weight=10.0)(
        {"fg_kp": jnp.asarray(kp_d)}, {"fg_kp": jnp.asarray(kp_t)}, p)
    got = tl.TPSM_EquivarianceLoss(loss_weight=10.0)(
        {"fg_kp": torch.from_numpy(kp_d)}, {"fg_kp": torch.from_numpy(kp_t)},
        tp)
    _close(got, want)


def test_tpsm_bg_loss_matches_jax():
    a, b = _arr((2, 3, 3), 8), _arr((2, 3, 3), 9)
    want = jl.TPSM_BGLoss(loss_weight=10.0)(jnp.asarray(a), jnp.asarray(b))
    got = tl.TPSM_BGLoss(loss_weight=10.0)(torch.from_numpy(a),
                                           torch.from_numpy(b))
    _close(got, want)


# ---------------------------------------------------------------------------
# PerceptualLoss over VGG19Features
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg():
    """(jitted JAX VGG19Features apply, its params, the port's
    VGG19Features on the same weights)."""
    jm = JaxVGG19Features()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    params = random_params(shapes["params"], 11)
    net = VGG19Features().eval().requires_grad_(False)
    net.load_state_dict(weights.vgg_state_dict(params), strict=True)
    return jax.jit(lambda p, x: jm.apply({"params": p}, x)), params, net


PERCEPTUAL = {
    "l1": dict(criterion="l1"),
    "l2": dict(criterion="l2"),
    "mse_range_norm": dict(criterion="mse", range_norm=True),
    "fro": dict(criterion="fro"),
    "l1_style": dict(criterion="l1", style_weight=2.0),
    "fro_style_only": dict(criterion="fro", perceptual_weight=0.0,
                           style_weight=1.0),
}


@pytest.mark.parametrize("case", sorted(PERCEPTUAL))
def test_perceptual_loss_matches_jax(vgg, case):
    vgg_apply, params, net = vgg
    layer_weights = {"relu1_1": 0.5, "conv2_2": 1.0, "relu3_1": 0.25,
                     "conv4_4": 1.0, "relu5_1": 0.1, "pool9": 3.0}
    kw = {"layer_weights": layer_weights, "perceptual_weight": 1.5,
          **PERCEPTUAL[case]}
    x, gt = _arr((2, 32, 32, 3), 12), _arr((2, 32, 32, 3), 13)
    jloss = jl.PerceptualLoss(lambda p, v: vgg_apply(p, v), **kw)
    want = jloss(params, jnp.asarray(x), jnp.asarray(gt))
    xt = _nchw(x).requires_grad_()
    got = tl.PerceptualLoss(**kw)(net, xt, _nchw(gt))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w)
    # the target's features carry no gradient: the loss reaches x only
    total = sum(g for g in got if isinstance(g, torch.Tensor))
    if isinstance(total, torch.Tensor) and total.requires_grad:
        total.backward()
        assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_perceptual_loss_rejects_unknown_criterion():
    with pytest.raises(NotImplementedError):
        tl.PerceptualLoss(layer_weights={"relu1_1": 1.0}, criterion="l3")


# ---------------------------------------------------------------------------
# gradient penalties
# ---------------------------------------------------------------------------

IMG = (2, 6, 6, 3)   # NHWC on the JAX side
HIDDEN = 16


@pytest.fixture(scope="module")
def disc():
    """A linear + LeakyReLU(0.2) + linear discriminator on both sides,
    reading the image in NCHW order: (JAX apply of (params, NHWC image),
    its params, the port's apply of (weights, NCHW image), its weights as
    leaves that require grad)."""
    n = IMG[1] * IMG[2] * IMG[3]
    rng = np.random.RandomState(14)
    p = {"w1": (rng.standard_normal((n, HIDDEN)) / np.sqrt(n)).astype(
        np.float32),
         "b1": (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32),
         "w2": (rng.standard_normal((HIDDEN, 1)) / 4).astype(np.float32),
         "b2": np.float32([0.05])}

    def japply(q, x):
        h = x.transpose(0, 3, 1, 2).reshape(x.shape[0], -1) @ q["w1"] \
            + q["b1"]
        return jax.nn.leaky_relu(h, 0.2) @ q["w2"] + q["b2"]

    def tapply(q, x):
        h = x.reshape(x.shape[0], -1) @ q["w1"] + q["b1"]
        return torch.nn.functional.leaky_relu(h, 0.2) @ q["w2"] + q["b2"]

    def tweights():
        return {k: torch.from_numpy(v.copy()).requires_grad_()
                for k, v in p.items()}

    return japply, {k: jnp.asarray(v) for k, v in p.items()}, tapply, tweights


def _close_grads(loss, weights_, jgrads):
    """The gradient of the port's ``loss`` to ``weights_`` (None, for a
    weight it does not reach, as 0) against JAX's."""
    grads = torch.autograd.grad(loss, list(weights_.values()),
                                allow_unused=True)
    for (k, w), g in zip(weights_.items(), grads):
        _close(torch.zeros_like(w) if g is None else g, jgrads[k])


def test_r1_penalty_matches_jax(disc):
    japply, jp, tapply, tweights = disc
    real = _arr(IMG, 15)

    def jpen(q):
        return jl.r1_penalty(lambda x: japply(q, x), jnp.asarray(real))

    want, jgrads = jax.value_and_grad(jpen)(jp)
    q = tweights()
    got = tl.r1_penalty(lambda x: tapply(q, x), _nchw(real))
    _close(got, want)
    _close_grads(got, q, jgrads)


@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_penalty_loss_matches_jax(disc, monkeypatch, weighted):
    japply, jp, tapply, tweights = disc
    real, fake = _arr(IMG, 16), _arr(IMG, 17)
    wmap = _arr(IMG[:3] + (1,), 18, 0.5, 1.0) if weighted else None
    key = jax.random.PRNGKey(19)
    alpha = np.asarray(jax.random.uniform(key, (IMG[0], 1, 1, 1)))
    drawn = []

    def draw(n, generator, device, dtype):
        assert generator is not None and n == IMG[0]
        drawn.append(n)
        return torch.from_numpy(alpha.copy())

    monkeypatch.setattr(tl, "_draw_alpha", draw)

    def jpen(q):
        return jl.gradient_penalty_loss(
            lambda x: japply(q, x), jnp.asarray(real), jnp.asarray(fake),
            key, None if wmap is None else jnp.asarray(wmap))

    want, jgrads = jax.value_and_grad(jpen)(jp)
    q = tweights()
    got = tl.gradient_penalty_loss(
        lambda x: tapply(q, x), _nchw(real), _nchw(fake),
        torch.Generator().manual_seed(0),
        None if wmap is None else _nchw(wmap))
    assert drawn
    _close(got, want)
    _close_grads(got, q, jgrads)


def test_g_path_regularize_matches_jax(monkeypatch):
    n_latent, dim = 3, 4
    rng = np.random.RandomState(20)
    latents = rng.standard_normal((IMG[0], n_latent, dim)).astype(np.float32)
    w = (rng.standard_normal((n_latent * dim, int(np.prod(IMG[1:]))))
         / 3).astype(np.float32)
    key = jax.random.PRNGKey(21)
    noise = np.asarray(jax.random.normal(key, IMG))
    monkeypatch.setattr(
        tl, "_draw_path_noise",
        lambda shape, generator, device, dtype: _nchw(noise))

    def jgen(wq, lat):
        return jnp.tanh(lat.reshape(IMG[0], -1) @ wq).reshape(IMG)

    def jrun(wq):
        lat = jnp.asarray(latents)
        fake = jgen(wq, lat)
        return jl.g_path_regularize(
            fake, lambda nz: jax.grad(lambda l_: jnp.sum(
                jgen(wq, l_) * nz))(lat), 0.5, key)

    want = jrun(jnp.asarray(w))
    jgrad = jax.grad(lambda wq: jrun(wq)[0])(jnp.asarray(w))

    wt = torch.from_numpy(w).requires_grad_()
    lat = torch.from_numpy(latents).requires_grad_()
    fake = torch.tanh(lat.reshape(IMG[0], -1) @ wt).reshape(IMG).permute(
        0, 3, 1, 2)
    got = tl.g_path_regularize(
        fake, lambda nz: torch.autograd.grad((fake * nz).sum(), lat,
                                             create_graph=True)[0],
        0.5, torch.Generator().manual_seed(0))
    for g, v in zip(got, want):
        _close(g, v)
    assert not got[1].requires_grad and not got[2].requires_grad
    _close(torch.autograd.grad(got[0], wt)[0], jgrad)
