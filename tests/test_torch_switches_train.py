"""The training side of the ablation switches (test_torch_switches'
VARIANTS) at the tiny config: the gradient of the motion estimator (in
train mode) and the generator's training forward, for the two variants
that change the graph most, against the JAX package's; the port's
training step under three switches; and the errors both packages raise
for combinations they cannot run.

Gradient bounds are the train step test's (tests/test_torch_train_step.py,
whose docstring measures them): per leaf max |port - JAX| <= r * max |JAX
leaf| + 2e-5 * max |JAX network|, with r = 1e-3 for the generator and
2e-3 for the motion networks, and 1e-3 (generator) and 3e-3 (motion
networks) relative in each network's 2-norm; the gradient with respect
to each dense-motion input within the generator's 2-norm bound. Except
one: the generator of the variant without MRFA and warped-source
queries is held in 2-norm alone, at 1e-2. On these inputs one LeakyReLU
pre-activation of its
16x16 SFT block (fuse_convs_dict.16.shift) sits 2.9e-7 from zero, and a
change of the dense motion by 2e-6 (the JAX motion estimator jitted or
not) flips it: the port's gradient then moves by 4.3e-3 in 2-norm and
3.5% on that block's leaves, in float64 as in float32. The two
frameworks' roundings place it on either side, so their gradients lie
2.7e-3 apart (2-norm) and 5.6% on the bias of the kinked channel's conv
(fuse_convs_dict.16.shift.0.bias), while each of the scalar's terms
alone agrees within 1.7e-5 on a dense motion away from the kink.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.losses import (  # noqa: E402
    EquivarianceLoss as JaxEquivarianceLoss,
)
from synergize_motion_appearance_tpu.ops import (  # noqa: E402
    sample_random_tps as jax_sample_tps,
)
from synergize_motion_appearance_tpu_torch import weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.losses import (  # noqa: E402
    EquivarianceLoss,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    RandomTPSParams,
)
from synergize_motion_appearance_tpu_torch.training import Trainer  # noqa: E402
from test_torch_models import _images, _nchw, port_nets  # noqa: E402
from test_torch_switches import (  # noqa: E402
    VARIANTS,
    jax_build,
    jax_variables,
    port_dense_motion,
    variant_cfg,
)
from test_torch_train_step import _batch  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401


def _scalar(out, w):
    """A fixed weighted sum of the generator's training outputs."""
    s = (out["out"] * w["out"]).sum() + (out["out_lr"][0] * w["lr"]).sum()
    s = s + out["pre_final"].mean()
    for r in out["motion_recon_list"]:
        s = s + (r * w["rec"]).sum()
    for loss in (out["codebook_loss_motion_list"]
                 + out["codebook_loss_app_list"]):
        s = s + loss
    for occ in out["out_occ"]:
        s = s + occ.mean()
    return s


# (per-leaf r, 2-norm bound) by network, and the generator's of the
# variant whose SFT block has a LeakyReLU at its kink (module docstring)
BOUNDS = {"g": (1e-3, 1e-3), "m": (2e-3, 3e-3)}
KINK_G = {"no_warp_query_no_mrfa": (None, 1e-2)}
DM_KEYS = ("deformation", "occlusion_map", "driving_kp_heatmap")


def _hold_grads(module, want, bounds):
    """``module``'s parameter gradients against ``want`` (by name) within
    ``bounds``: (per-leaf r, or None for none; 2-norm)."""
    r, norm_bound = bounds
    params = dict(module.named_parameters())
    floor = 2e-5 * max(np.abs(want[k].numpy()).max() for k in params)
    diffs, norms = [], []
    for name, p in params.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        ref = want[name].numpy()
        if r is not None:
            bound = r * np.abs(ref).max() + floor
            assert np.abs(g - ref).max() <= bound, (
                name, np.abs(g - ref).max(), bound)
        diffs.append(((g - ref) ** 2).sum())
        norms.append((ref ** 2).sum())
    assert np.sqrt(sum(diffs) / sum(norms)) <= norm_bound


def _leaves_t(dm):
    """The dense motion's tensors in DM_KEYS order, occlusion maps
    flattened."""
    occ = dm["occlusion_map"]
    return [dm["deformation"], dm["driving_kp_heatmap"]] + (
        list(occ) if isinstance(occ, (list, tuple)) else [occ])


@pytest.mark.parametrize("name", ["no_warp_query_no_mrfa", "multi_mask"])
def test_gradient(name):
    """The gradient of _scalar of the generator's training forward with
    respect to its weights and to its dense-motion input, on the dense
    motion of the JAX motion estimator in train mode; and that input
    gradient carried back through each side's motion estimator in train
    mode to its weights. Each side's generator reads the same dense
    motion: the gradient steps where an activation crosses its kink, and
    float32 noise in the dense motion moves such crossings."""
    cfg = variant_cfg(name)
    jg = jax_build(dict(cfg["network_g"]))
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    g_vars, m_vars = jax_variables(cfg)
    tg, tme = port_nets(cfg, g_vars, m_vars)
    # image-like frames: white noise blurs to near-constant images at the
    # keypoint detector's scale, where train-mode BatchNorm divides
    # rounding noise by ~sqrt(eps) (test_torch_train_step._batch)
    batch = _batch()
    src, drv = np.asarray(batch["source"]), np.asarray(batch["driving"])
    rng = np.random.RandomState(52)
    w = {"out": rng.randn(2, 64, 64, 3).astype(np.float32),
         "lr": rng.randn(2, 64, 64, 3).astype(np.float32),
         "rec": rng.randn(2, 16, 16, 2).astype(np.float32)}

    def motion(mp):
        dm, _ = jme.apply({"params": mp,
                           "batch_stats": m_vars["batch_stats"]},
                          jnp.asarray(drv), jnp.asarray(src), train=True,
                          mutable=["batch_stats"])
        return {k: dm[k] for k in DM_KEYS}

    def loss(gp, dm):
        return _scalar(jg.apply({"params": gp}, jnp.asarray(src), dm,
                                gt=jnp.asarray(drv)), w)

    # three programs, so that the JAX generator reads the very dense
    # motion the port's does: one program would let XLA recompute it in
    # other roundings, which can flip the appearance pass's mask
    jdm = jax.jit(motion)(m_vars["params"])
    jval, (g_grad, dm_grad) = jax.jit(jax.value_and_grad(loss, (0, 1)))(
        g_vars["params"], jdm)
    m_grad = jax.jit(lambda mp, ct: jax.vjp(motion, mp)[1](ct)[0])(
        m_vars["params"], dm_grad)

    dm_t = port_dense_motion(jdm)
    for t in _leaves_t(dm_t):
        t.requires_grad_(True)
    out = tg(_nchw(src), dm_t, gt=_nchw(drv))
    nhwc = {k: out[k].permute(0, 2, 3, 1) for k in ("out", "pre_final")}
    nhwc["out_lr"] = [out["out_lr"][0].permute(0, 2, 3, 1)]
    nhwc["out_occ"] = out["out_occ"]
    nhwc.update({k: out[k] for k in ("motion_recon_list",
                                     "codebook_loss_motion_list",
                                     "codebook_loss_app_list")})
    tval = _scalar(nhwc, {k: torch.from_numpy(v) for k, v in w.items()})
    assert abs(float(tval.detach()) - float(jval)) <= 1e-4 * abs(float(jval))
    tval.backward()
    g_bounds = KINK_G.get(name, BOUNDS["g"])
    _hold_grads(tg, weights.net_g_state_dict({"params": g_grad},
                                             cfg["network_g"]), g_bounds)
    cotangent = _leaves_t(port_dense_motion(dm_grad))
    for got, want in zip(_leaves_t(dm_t), cotangent):
        # an input the generator does not read (the last multi-mask map;
        # the keypoint heatmap without warped-source queries) has no grad
        got = torch.zeros_like(got) if got.grad is None else got.grad
        gap = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert gap <= g_bounds[1], gap

    tme.train()
    torch.autograd.backward(_leaves_t(tme(_nchw(drv), _nchw(src))),
                            cotangent)
    _hold_grads(tme, weights.motion_estimator_state_dict(
        {"params": m_grad, "batch_stats": m_vars["batch_stats"]},
        cfg["network_motion_estimator"]), BOUNDS["m"])


def _train_opt(name):
    opt = variant_cfg(name, "tiny_train")
    opt["train"]["net_d_start_iter"] = 0  # the D phase from step 1
    if not opt["network_motion_estimator"]["kp_detector_params"].get(
            "estimate_jacobian", True):
        opt["train"]["equivariance_opt"]["use_jacobian"] = False
    return opt


@functools.lru_cache(maxsize=None)
def _two_steps(name):
    """Log keys of two of the port's training steps on variant ``name`` (the
    second runs D and the adaptive weight); asserts they are finite and
    that the motion networks moved."""
    opt = _train_opt(name)
    tr = Trainer(opt, device="cpu", seed=0)
    batch = {k: torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2).copy())
             for k, v in _batch().items()}
    before = {k: p.detach().clone() for k, p in
              tr.motion_estimator.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    for step in range(2):
        logs = {k: float(v) for k, v in
                tr.train_step(batch, generator=gen).items()}
        for k, v in logs.items():
            assert np.isfinite(v), (step, k, v)
        assert logs["step_skipped_nonfinite"] == 0.0
    assert logs["d_weight"] > 0
    assert any(not torch.equal(p, before[k]) for k, p in
               tr.motion_estimator.named_parameters())
    return tuple(sorted(logs))


@pytest.mark.parametrize("name", ["no_mrfa", "multi_mask", "no_jacobian"])
def test_train_step(name):
    """Two training steps: finite logs, the motion networks moved, and the
    default config's log keys, which test_torch_train_step holds against
    the JAX step's. The networks' switches do not enter the JAX step's
    logs; it adds l_equivariance_jacobian only when the loss computes it
    (JAX training/trainer.py:620-622), not with use_jacobian false."""
    want = set(_two_steps(None))
    if not _train_opt(name)["train"]["equivariance_opt"]["use_jacobian"]:
        want.discard("l_equivariance_jacobian")
    assert set(_two_steps(name)) == want


def test_generator_without_occlusion_map_raises():
    """A motion estimator built with estimate_occlusion_map=False gives no
    'occlusion_map' on either side, and both generators then raise a
    KeyError (the JAX one reads the key unconditionally)."""
    cfg = variant_cfg(None)
    cfg["network_motion_estimator"]["dense_motion_params"][
        "estimate_occlusion_map"] = False
    jg = jax_build(dict(cfg["network_g"]))
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    src, drv = _images(2, 53), _images(2, 54)
    m_shapes = jax.eval_shape(jme.init, jax.random.PRNGKey(0),
                              jnp.asarray(drv), jnp.asarray(src))
    dm = jax.eval_shape(jme.apply, m_shapes, jnp.asarray(drv),
                        jnp.asarray(src))
    assert "occlusion_map" not in dm
    g_shapes = jax.eval_shape(
        lambda k, d: jg.init(k, jnp.asarray(src), d, inference=True),
        jax.random.PRNGKey(1), dict(dm, occlusion_map=jax.ShapeDtypeStruct(
            (2, 16, 16, 1), jnp.float32)))
    with pytest.raises(KeyError):
        jax.eval_shape(lambda v, d: jg.apply(v, jnp.asarray(src), d,
                                             inference=True), g_shapes, dm)

    tg, tme = weights.seeded_nets(cfg, 0)
    tme.eval()
    with torch.no_grad():
        tdm = tme(_nchw(drv), _nchw(src))
        assert "occlusion_map" not in tdm
        with pytest.raises(KeyError, match="estimate_occlusion_map"):
            tg(_nchw(src), tdm, inference=True)


def test_equivariance_jacobian_without_jacobians_raises():
    """use_jacobian on keypoints without Jacobians: a KeyError on both
    sides, from the loss and from the port's training step; with
    use_jacobian false the loss gives its value term alone."""
    rng = np.random.RandomState(55)
    kp = {"value": rng.uniform(-0.5, 0.5, (2, 5, 2)).astype(np.float32)}
    kp_t = {"value": rng.uniform(-0.5, 0.5, (2, 5, 2)).astype(np.float32)}
    tps = jax_sample_tps(jax.random.PRNGKey(2), 2, 0.05, 0.005, 5)
    ttps = RandomTPSParams(*(torch.from_numpy(np.array(a)) for a in tps))
    j_kp = {k: jnp.asarray(v) for k, v in kp.items()}
    j_kp_t = {k: jnp.asarray(v) for k, v in kp_t.items()}
    t_kp = {k: torch.from_numpy(v) for k, v in kp.items()}
    t_kp_t = {k: torch.from_numpy(v) for k, v in kp_t.items()}
    with pytest.raises(KeyError):
        JaxEquivarianceLoss()(j_kp, j_kp_t, tps)
    with pytest.raises(KeyError, match="estimate_jacobian"):
        EquivarianceLoss()(t_kp, t_kp_t, ttps)
    jv, jj = JaxEquivarianceLoss(use_jacobian=False)(j_kp, j_kp_t, tps)
    tv, tj = EquivarianceLoss(use_jacobian=False)(t_kp, t_kp_t, ttps)
    assert jj is None and tj is None
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)

    opt = _train_opt("no_jacobian")
    opt["train"]["equivariance_opt"]["use_jacobian"] = True
    tr = Trainer(opt, device="cpu", seed=0)
    batch = {k: torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2).copy())
             for k, v in _batch().items()}
    with pytest.raises(KeyError, match="estimate_jacobian"):
        tr.train_step(batch, generator=torch.Generator().manual_seed(0))


def test_variants_cover_every_switch():
    """VARIANTS sets every switch of the three networks away from its
    default once (quantizer_type and detach_motion_query, which no module
    reads, are test_torch_switches::test_switches_without_effect)."""
    switched = {k for ov in VARIANTS.values() for part in ov.values()
                for k in part}
    assert switched >= {
        "with_position_emb", "warp_s_d_kp_query", "MRFA_motion_enc",
        "motion_codebook_split", "wo_motion_cdbk_share",
        "app_codebook_split", "wo_app_cdbk_share", "multiscale_sft",
        "multiscale_feature_fusion", "multi_mask", "occlusion_num",
        "estimate_jacobian", "single_jacobian_map"}
