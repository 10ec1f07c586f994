"""The training slice's parts against the JAX package's, on the CPU, at the
tiny config: vector quantization, the TPS warps, the reflection warp, each
loss, train-mode BatchNorm, the discriminator, VGG19, the generator's
training forward and its gradient, the optimizer and the lr schedules,
and the weight exporters.

Inputs are made with numpy from fixed seeds; JAX weights are carried to
the port by weights.py. Tolerances: 1e-5 for forwards of single modules
and ops, 1e-4 relative for losses and gradients. The generator's training
forward is held at 2e-4 like its inference forward in
tests/test_torch_models.py: through its ~60 layers the two frameworks'
different summation orders add up to ~1e-5 at the [-1, 1] scale. Its
gradient is held at 1e-4 relative in the 2-norm over all weights, and per
weight at the train step's 1e-3 of the weight's largest gradient (the
deepest paths reach ~1.2e-4 there, measured on position_emb_motion) plus
the train step's floor, 2e-5 of the network's largest gradient, for the
conv biases in front of a GroupNorm with one channel per group (at the
tiny widths), whose exact gradient is 0 and which carry only rounding
residue.
"""
import sys
import types
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))

from convert_reference_checkpoint import (  # noqa: E402
    export_motion_estimator,
    export_net_d,
    export_net_g,
)
from convert_vgg_weights import (  # noqa: E402
    VGG19_CONV_IDX,
    torch_vgg_to_flax,
)

from synergize_motion_appearance_tpu import losses as jl  # noqa: E402
from synergize_motion_appearance_tpu import ops as jops  # noqa: E402
from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build,
)
from synergize_motion_appearance_tpu.models.layers import (  # noqa: E402
    BatchNorm2d as JaxBatchNorm2d,
)
from synergize_motion_appearance_tpu.models.vgg import (  # noqa: E402
    VGG19Features as JaxVGG,
)
from synergize_motion_appearance_tpu.models.vqgan import (  # noqa: E402
    VectorQuantizer as JaxVQ,
)
from synergize_motion_appearance_tpu.training import trainer as jtr  # noqa: E402
from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    configs,
    losses as tl,
    ops as tops,
    weights,
)
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    VGG19Features,
    build_network,
)
from synergize_motion_appearance_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm2d,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    Adam,
    AdamState,
    Trainer,
    make_schedule,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    trainer as ttr,
)

from test_torch_models import (  # noqa: E402
    _images,
    _nchw,
    _nhwc,
    _perturb,
    port_nets,
    tiny_jax_nets,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

FWD = 1e-5
REL = 1e-4


def _close(got, want, tol=FWD):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _rel(got, want, tol=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want) + 1e-7, (got, want)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# vector quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,num", [(0, None), (0, 24), (16, 16)],
                         ids=["full", "prefix", "range"])
def test_vq_quantize(start, num):
    """Indices (ties to the first entry: rows 0 and 1 of the codebook are
    equal), commit loss, and the straight-through gradients into z and
    the codebook."""
    rng = np.random.RandomState(0)
    z = rng.randn(2, 4, 4, 8).astype(np.float32)
    cb = rng.randn(48, 8).astype(np.float32)
    cb[start + 1] = cb[start]
    z[0, 0, 0] = cb[start] + 1e-3          # nearest to the duplicated pair
    r = rng.randn(*z.shape).astype(np.float32)

    def f(z_, cb_):
        zq, loss, stats = jops.vq_quantize(z_, cb_, 0.25, start, num)
        return (zq * r).sum() + loss, (zq, loss, stats)

    (_, (zq, loss, stats)), (gz, gcb) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))
    zt, cbt = _t(z).requires_grad_(), _t(cb).requires_grad_()
    zq_t, loss_t, stats_t = tops.vq_quantize(zt, cbt, 0.25, start, num)
    ((zq_t * _t(r)).sum() + loss_t).backward()
    idx = stats_t["min_encoding_indices"].numpy()
    np.testing.assert_array_equal(idx, np.asarray(
        stats["min_encoding_indices"]))
    assert idx[0, 0, 0] == 0, "a tie goes to the first entry"
    _close(zq_t.detach(), zq)
    _rel(loss_t, loss)
    _rel(stats_t["perplexity"], stats["perplexity"])
    _close(zt.grad, gz, REL)
    _close(cbt.grad, gcb, REL)
    _close(tops.vq_lookup(stats_t["min_encoding_indices"], cbt.detach()
                          [start:], zq_t.shape), zq)


# ---------------------------------------------------------------------------
# TPS warps and the reflection warp of the equivariance loss
# ---------------------------------------------------------------------------

def _tps_pair(seed=1, batch=2):
    p = jops.sample_random_tps(jax.random.PRNGKey(seed), batch, 0.05,
                               0.005, 5)
    return p, tops.RandomTPSParams(*(_t(a) for a in p))


def test_tps_warps_and_jacobian():
    jp, tp = _tps_pair()
    pts = np.random.RandomState(2).uniform(-1, 1, (2, 7, 2)).astype(
        np.float32)
    _close(tops.tps_warp_coordinates(tp, _t(pts)),
           jops.tps_warp_coordinates(jp, jnp.asarray(pts)))
    _close(tops.tps_warp_frame_grid(tp, 16, 12),
           jops.tps_warp_frame_grid(jp, 16, 12))
    _close(tops.tps_jacobian(tp, _t(pts)),
           jops.tps_jacobian(jp, jnp.asarray(pts)))


def test_sample_random_tps_from_generator():
    """Seeded by a torch.Generator: reproducible, the JAX shapes, the
    control points on a 5x5 grid, theta near the identity."""
    a = tops.sample_random_tps(torch.Generator().manual_seed(3), 4, 0.05,
                               0.005, 5)
    b = tops.sample_random_tps(torch.Generator().manual_seed(3), 4, 0.05,
                               0.005, 5)
    jp, _ = _tps_pair(batch=4)
    for x, y, j in zip(a, b, jp):
        assert torch.equal(x, y) and tuple(x.shape) == j.shape
    _close(a.control_points, jp.control_points)
    assert (a.theta - torch.eye(2, 3)).abs().max() < 0.05 * 6


def test_reflection_warp():
    """grid_sample with padding_mode='reflection', align_corners=False, on
    a grid reaching past the frame on every side."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (2, 7, 5, 2)).astype(np.float32)
    want = jops.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                            align_corners=False, padding_mode="reflection")
    got = tops.grid_sample(_nchw(img), _t(grid), align_corners=False,
                           padding_mode="reflection")
    _close(_nhwc(got), want)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gan_type", ["hinge", "vanilla", "lsgan", "wgan",
                                      "wgan_softplus"])
def test_gan_loss(gan_type):
    pred = np.random.RandomState(5).randn(2, 6, 6, 1).astype(np.float32)
    j = jl.GANLoss(gan_type, loss_weight=0.7)
    t = tl.GANLoss(gan_type, loss_weight=0.7)
    for real in (True, False):
        for disc in (True, False):
            _rel(t(_t(pred), real, is_disc=disc),
                 j(jnp.asarray(pred), real, is_disc=disc))


def test_l1_and_kp_distance_losses():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2, 3, 5, 5), rng.randn(2, 3, 5, 5)
    for red in ("mean", "sum"):
        _rel(tl.L1Loss(2.0, red)(_t(a), _t(b)),
             jl.L1Loss(2.0, red)(jnp.asarray(a), jnp.asarray(b)))
    kp_d = {"value": rng.uniform(-1, 1, (2, 5, 2)).astype(np.float32)}
    kp_s = {"value": rng.uniform(-1, 1, (2, 5, 2)).astype(np.float32)}
    kp_s["value"][0, 1] = kp_s["value"][0, 0] + 0.05   # one close pair
    want = jl.KPDistanceLoss(1.0)(
        {k: jnp.asarray(v) for k, v in kp_d.items()},
        {k: jnp.asarray(v) for k, v in kp_s.items()})
    got = tl.KPDistanceLoss(1.0)({"value": _t(kp_d["value"])},
                                 {"value": _t(kp_s["value"])})
    _rel(got, want)


def test_equivariance_loss():
    rng = np.random.RandomState(7)

    def kp():
        return {"value": rng.uniform(-0.8, 0.8, (2, 5, 2)).astype(
                    np.float32),
                "jacobian": (np.eye(2) + 0.1 * rng.randn(2, 5, 2, 2)
                             ).astype(np.float32)}

    kp_d, kp_t = kp(), kp()
    jp, tp = _tps_pair(8)
    j = jl.EquivarianceLoss()(
        {k: jnp.asarray(v) for k, v in kp_d.items()},
        {k: jnp.asarray(v) for k, v in kp_t.items()}, jp)
    t = tl.EquivarianceLoss()({k: _t(v) for k, v in kp_d.items()},
                              {k: _t(v) for k, v in kp_t.items()}, tp)
    for got, want in zip(t, j):
        _rel(got, want)


# ---------------------------------------------------------------------------
# train-mode BatchNorm, the discriminator, VGG19 and the perceptual loss
# ---------------------------------------------------------------------------

def test_batchnorm_train_mode():
    """Batch statistics normalise; the running variance moves toward the
    BIASED batch variance (flax), not the unbiased one (torch's module);
    eval mode uses the running statistics."""
    rng = np.random.RandomState(9)
    x = (2.0 + 3.0 * rng.randn(2, 5, 4, 6)).astype(np.float32)   # NHWC
    jbn = JaxBatchNorm2d(6)
    v = _perturb(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False),
                 10)
    y, mut = jbn.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    e = weights._Exporter({"params": {"bn": v["params"]},
                           "batch_stats": {"bn": v["batch_stats"]}})
    e.bn("b", "bn")
    bn = BatchNorm2d(6)
    bn.load_state_dict({k[2:]: t for k, t in e.state_dict().items()})
    rv0 = bn.running_var.clone()
    got = bn.train()(_nchw(x))
    _close(_nhwc(got.detach()), y)
    stats = mut["batch_stats"]["BatchNorm_0"]
    _close(bn.running_mean, stats["mean"])
    _close(bn.running_var, stats["var"])
    biased = x.reshape(-1, 6).var(axis=0)
    _close(bn.running_var, 0.9 * rv0.numpy() + 0.1 * biased)
    unbiased = x.reshape(-1, 6).var(axis=0, ddof=1)
    assert np.abs(bn.running_var.numpy()
                  - (0.9 * rv0.numpy() + 0.1 * unbiased)).max() > 1e-3
    y_eval = jbn.apply(mut | {"params": v["params"]}, jnp.asarray(x), False)
    _close(_nhwc(bn.eval()(_nchw(x)).detach()), y_eval)


@pytest.fixture(scope="module")
def disc():
    cfg = configs.get("tiny_train")["network_d"]
    x = _images(2, 11)
    jd = jax_build(dict(cfg))
    v = _perturb(jax.jit(jd.init)(jax.random.PRNGKey(12), jnp.asarray(x)),
                 13)
    td = build_network(cfg)
    td.load_state_dict(weights.net_d_state_dict(v, cfg["n_layers"]),
                       strict=True)
    return cfg, jd, v, td


def test_discriminator(disc):
    """Train mode twice in a row (statistics chained, as the D phase
    does), then eval mode."""
    _, jd, v, td = disc
    x1, x2 = _images(2, 14), _images(2, 15)
    td.train()
    vars_ = v
    for x in (x1, x2):
        want, mut = jd.apply(vars_, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        vars_ = {"params": v["params"], **mut}
        with torch.no_grad():
            got = td(_nchw(x))
        _close(_nhwc(got), want, 1e-4)
    sd = td.state_dict()
    e = weights.net_d_state_dict(vars_, 2)
    for k, t in e.items():
        _close(sd[k], t)
    with torch.no_grad():
        got = td.eval()(_nchw(x1))
    _close(_nhwc(got), jd.apply(vars_, jnp.asarray(x1), train=False), 1e-4)


@pytest.fixture(scope="module")
def vgg():
    jv = JaxVGG()
    params = jax.jit(jv.init)(jax.random.PRNGKey(16),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    params = _perturb({"params": params}, 17)["params"]
    tv = VGG19Features()
    tv.load_state_dict(weights.vgg_state_dict(params), strict=True)
    return jv, params, tv


def test_vgg19_features(vgg):
    jv, params, tv = vgg
    x = _images(2, 18)[:, :32, :32]
    want = jv.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tv(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        scale = float(np.abs(np.asarray(w)).max())
        _close(_nhwc(g) / scale, np.asarray(w) / scale)


def test_perceptual_loss(vgg):
    """The pyramid loss at scales (1, 0.5), and its gradient to the
    prediction; the target's features computed once and reused."""
    jv, params, tv = vgg
    pred, target = _images(2, 19), _images(2, 20)
    jloss = jl.MultiScalePyramidPerceptualLoss(
        lambda p, x: jv.apply({"params": p}, x), scales=(1, 0.5))
    want, gwant = jax.value_and_grad(lambda p_: jloss(
        params, p_, jnp.asarray(target)))(jnp.asarray(pred))
    tloss = tl.MultiScalePyramidPerceptualLoss(scales=(1, 0.5))
    pt = _nchw(pred).requires_grad_()
    feats = tloss.target_features(tv, _nchw(target))
    got = tloss.from_target_feats(tv, pt, feats)
    got.backward()
    _rel(got, want)
    _rel(tloss(tv, pt.detach(), _nchw(target)), want)
    scale = float(np.abs(np.asarray(gwant)).max())
    _close(_nhwc(pt.grad) / scale, np.asarray(gwant) / scale, REL)


# ---------------------------------------------------------------------------
# the motion networks in train mode, and the generator's training forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    cfg = configs.get("tiny")
    jg, jme, g_vars, m_vars = tiny_jax_nets(cfg)
    tg, tme = port_nets(cfg, g_vars, m_vars)
    return cfg, jg, jme, g_vars, m_vars, tg, tme


def test_motion_estimator_train_mode(nets):
    """The training step's motion calls: the forward on (driving, source),
    then estimate_kp on a third frame, in train mode with the BatchNorm
    statistics chained through both calls."""
    cfg, _, jme, _, m_vars, _, tme = nets
    drv, src, third = _images(2, 21), _images(2, 22), _images(2, 23)

    @jax.jit
    def run(v):
        dm, mut = jme.apply(v, drv, src, train=True,
                            mutable=["batch_stats"])
        kp, mut = jme.apply({"params": v["params"], **mut}, third,
                            train=True, method="estimate_kp",
                            mutable=["batch_stats"])
        return dm, kp, mut

    dm, kp, mut = run(m_vars)
    tme.train()
    try:
        with torch.no_grad():
            tdm = tme(_nchw(drv), _nchw(src))
            tkp = tme.estimate_kp(_nchw(third))
    finally:
        tme.eval()
    _close(tdm["deformation"], dm["deformation"], 1e-4)
    _close(_nhwc(tdm["occlusion_map"]), dm["occlusion_map"], 1e-4)
    for k in ("value", "jacobian"):
        _close(tdm["kp_driving"][k], dm["kp_driving"][k], 1e-4)
        _close(tkp[k], kp[k], 1e-4)
    sd = tme.state_dict()
    want = weights.motion_estimator_state_dict(
        {"params": m_vars["params"], **mut},
        cfg["network_motion_estimator"])
    for k, t in want.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], t, 1e-4)
    tme.load_state_dict(weights.motion_estimator_state_dict(
        m_vars, cfg["network_motion_estimator"]))


def test_generator_training_forward_and_grad(nets):
    """Every output the trainer reads (out, pre_final, out_lr,
    deformation_list, motion_recon_list and both commit-loss lists), the
    quantizers' indices, and the gradient to every generator weight of a
    scalar of those outputs."""
    cfg, jg, jme, g_vars, m_vars, tg, _ = nets
    src, drv = _images(2, 24), _images(2, 25)
    dm = jax.jit(jme.apply)(m_vars, jnp.asarray(drv), jnp.asarray(src))
    rng = np.random.RandomState(26)
    wts = {"out": rng.randn(2, 64, 64, 3).astype(np.float32),
           "lr": rng.randn(2, 64, 64, 3).astype(np.float32),
           "rec": rng.randn(2, 16, 16, 2).astype(np.float32)}

    def scalar(out, w):
        s = (out["out"] * w["out"]).sum() + (out["out_lr"][0] * w["lr"]).sum()
        s = s + out["pre_final"].mean()
        for r in out["motion_recon_list"]:
            s = s + (r * w["rec"]).sum()
        for loss in (out["codebook_loss_motion_list"]
                     + out["codebook_loss_app_list"]):
            s = s + loss
        return s

    def jfun(params):
        out, inter = jg.apply(
            {"params": params}, jnp.asarray(src), dm, gt=jnp.asarray(drv),
            capture_intermediates=lambda m, _: isinstance(m, JaxVQ))
        return scalar(out, wts), (out, inter["intermediates"])

    (jval, (jout, inter)), jgrad = jax.jit(
        jax.value_and_grad(jfun, has_aux=True))(g_vars["params"])

    indices = {"quantize_motion": [], "quantize_app": []}
    hooks = [getattr(tg, q).register_forward_hook(
        lambda mod, inp, res, q=q: indices[q].append(
            res[2]["min_encoding_indices"])) for q in indices]
    dm_t = {"deformation": _t(dm["deformation"]),
            "occlusion_map": _nchw(dm["occlusion_map"]),
            "driving_kp_heatmap": _t(dm["driving_kp_heatmap"])}
    try:
        out = tg(_nchw(src), dm_t, gt=_nchw(drv))
    finally:
        for h in hooks:
            h.remove()
    nhwc = {k: out[k].permute(0, 2, 3, 1) for k in ("out", "pre_final")}
    nhwc["out_lr"] = [out["out_lr"][0].permute(0, 2, 3, 1)]
    nhwc.update({k: out[k] for k in ("motion_recon_list",
                                     "codebook_loss_motion_list",
                                     "codebook_loss_app_list")})
    tval = scalar(nhwc, {k: _t(v) for k, v in wts.items()})

    _close(nhwc["out"].detach(), jout["out"], 2e-4)
    _close(nhwc["pre_final"].detach(), jout["pre_final"], 2e-4)
    _close(nhwc["out_lr"][0].detach(), jout["out_lr"][0], 2e-4)
    for a, b in zip(out["deformation_list"], jout["deformation_list"]):
        _close(a.detach(), b, 2e-4)
    for a, b in zip(out["motion_recon_list"], jout["motion_recon_list"]):
        _close(a.detach(), b, 2e-4)
    for key in ("codebook_loss_motion_list", "codebook_loss_app_list"):
        assert len(out[key]) == len(jout[key]) == 4
        for a, b in zip(out[key], jout[key]):
            _rel(a, b)
    for q, got in indices.items():
        want = [stats["min_encoding_indices"]
                for _, _, stats in inter[q]["__call__"]]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _rel(tval.detach(), jval)

    tval.backward()
    want = weights.net_g_state_dict({"params": jgrad}, cfg["network_g"])
    # the train step's floor for leaves whose exact gradient is 0
    floor = 2e-5 * max(np.abs(w.numpy()).max() for w in want.values())
    diffs, norms = [], []
    for name, p in tg.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        w = want[name].numpy()
        # per leaf, the train step's bound (tests/test_torch_train_step.py)
        bound = 1e-3 * np.abs(w).max() + floor
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)
        diffs.append(((g - w) ** 2).sum())
        norms.append((w ** 2).sum())
    tg.zero_grad()
    # over all leaves together, relative 1e-4 in the 2-norm
    assert np.sqrt(sum(diffs) / sum(norms)) <= REL


# ---------------------------------------------------------------------------
# optimizer, schedules, weights
# ---------------------------------------------------------------------------

def test_adam_matches_optax():
    rng = np.random.RandomState(27)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = optax.scale_by_adam(b1=0.9, b2=0.99)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    ts = AdamState.zeros(tp)
    adam = Adam({"betas": [0.9, 0.99]})
    for step in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        lr = 8e-5 * (step + 1)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(
            jp, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        adam.step(ts, tp, {k: _t(v) for k, v in g.items()}, lr)
    assert ts.count == int(js.count) == 3
    for k in params:
        _close(tp[k], jp[k], 1e-6)
        _close(ts.mu[k], js.mu[k], 1e-6)
        _close(ts.nu[k], js.nu[k], 1e-6)


@pytest.mark.parametrize("sched", [
    {"type": "MultiStepLR", "milestones": [4, 6], "gamma": 0.5},
    {"type": "MultiStepRestartLR", "milestones": [3, 8], "gamma": 0.1,
     "restarts": [0, 5], "restart_weights": [1, 0.5]},
    {"type": "CosineAnnealingRestartLR", "periods": [4, 6],
     "restart_weights": [1, 0.5], "eta_min": 1e-6},
    {}], ids=["multistep", "restart", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [-1, 3])
def test_lr_schedules(sched, warmup):
    _, want = jtr._make_optimizer({"lr": 8e-5}, sched, warmup)
    got = make_schedule({"lr": 8e-5}, sched, warmup)
    for count in range(12):
        assert abs(got(count) - float(want(count))) <= 1e-6 * 8e-5, count


@pytest.mark.parametrize("yml", [
    "tiny_train.yml", "train.yml", "train_onset.yml", "train_soak.yml",
    "train_synth_disk.yml", "train_v5e2.yml", "train_v5e8.yml"])
def test_trainer_takes_jax_train_options(yml):
    """Every train block of the JAX package's option files is taken by the
    trainer, and so are a fixed GAN weight and Adam's weight decay on top
    of it, which no file sets: each optimizer reads its own
    ``weight_decay``, as the JAX ``_make_optimizer`` does."""
    yaml = pytest.importorskip("yaml")
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(root, "options", yml)) as f:
        train = yaml.safe_load(f)["train"]
    for name in ("optim_g", "optim_motion", "optim_d"):
        cfg = train.get(name, train["optim_g"])
        assert ttr.Adam(cfg).weight_decay == float(
            cfg.get("weight_decay", 0.0))
        assert ttr.Adam(dict(cfg, weight_decay=1e-4)).weight_decay == 1e-4
    opt = configs.get("tiny_train")
    opt["train"]["use_adaptive_weight"] = False
    opt["train"]["optim_d"] = dict(opt["train"]["optim_d"],
                                   weight_decay=1e-4)
    tr = Trainer(opt, device="cpu")
    assert not tr.use_adaptive_weight
    assert (tr.adam_g.weight_decay, tr.adam_d.weight_decay) == (0.0, 1e-4)


def test_net_d_and_vgg_exports_match_tools(disc):
    """weights.py gives the state_dicts of the repo's converters, name for
    name and value for value: the discriminator as export_net_d, VGG19 as
    the inverse of convert_vgg_weights.torch_vgg_to_flax."""
    cfg, _, v, _ = disc
    ours = weights.net_d_state_dict(v, cfg["n_layers"])
    theirs = export_net_d(v, cfg["n_layers"])
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
    rng = np.random.RandomState(28)
    tv_sd = {}
    for i, idx in enumerate(VGG19_CONV_IDX[:13]):
        tv_sd[f"features.{idx}.weight"] = rng.randn(4, 3, 3, 3).astype(
            np.float32) + i
        tv_sd[f"features.{idx}.bias"] = rng.randn(4).astype(np.float32)
    back = weights.vgg_state_dict(torch_vgg_to_flax(tv_sd))
    assert sorted(back) == sorted(tv_sd)
    for k in tv_sd:
        np.testing.assert_array_equal(back[k].numpy(), tv_sd[k], err_msg=k)


def test_load_train_state(nets, disc):
    """A whole JAX TrainState goes into a Trainer: weights and statistics
    as the tools' exports, the EMA, the Adam moments and counts, the
    step."""
    cfg, _, _, g_vars, m_vars, _, _ = nets
    _, _, d_vars, _ = disc
    opt = configs.get("tiny_train")
    tx = optax.scale_by_adam()

    def adam_state(params, count, seed):
        s = tx.init(params)
        noisy = _perturb({"params": params}, seed)["params"]
        return s._replace(count=jnp.asarray(count, jnp.int32), mu=noisy,
                          nu=jax.tree_util.tree_map(np.abs, noisy))

    st = types.SimpleNamespace(
        step=np.int32(7), params_g=g_vars["params"],
        params_m=m_vars["params"], params_d=d_vars["params"],
        stats_m=m_vars["batch_stats"], stats_d=d_vars["batch_stats"],
        ema_g=_perturb({"params": g_vars["params"]}, 29)["params"],
        opt_g=adam_state(g_vars["params"], 7, 30),
        opt_m=adam_state(m_vars["params"], 7, 31),
        opt_d=adam_state(d_vars["params"], 2, 32))
    tr = Trainer(opt, device="cpu")
    weights.load_train_state(tr, st)
    me_cfg = cfg["network_motion_estimator"]
    for module, theirs in (
            (tr.net_g, export_net_g(g_vars, dict(cfg["network_g"]))),
            (tr.motion_estimator, export_motion_estimator(
                m_vars, num_blocks_kp=2, num_blocks_dm=2,
                scale_factor=0.25)),
            (tr.net_d, export_net_d(d_vars, 2))):
        sd = module.state_dict()
        for k, t in theirs.items():
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(t),
                                          err_msg=k)
    assert tr.state.step == 7
    assert (tr.state.opt_g.count, tr.state.opt_m.count,
            tr.state.opt_d.count) == (7, 7, 2)
    ema = export_net_g({"params": st.ema_g}, dict(cfg["network_g"]))
    mu_m = export_motion_estimator(
        {"params": st.opt_m.mu, "batch_stats": m_vars["batch_stats"]},
        num_blocks_kp=2, num_blocks_dm=2, scale_factor=0.25)
    for k, t in tr.state.ema_g.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ema[k]))
    for k, t in tr.state.opt_m.mu.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(mu_m[k]))
    assert sorted(tr.state.opt_m.mu) == sorted(
        dict(tr.motion_estimator.named_parameters()))
    assert sorted(tr.state.opt_d.nu) == sorted(
        dict(tr.net_d.named_parameters()))
