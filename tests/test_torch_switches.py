"""Every configuration switch of the generator, the keypoint detector and
the dense-motion network (the paper's ablations): the port against the JAX
package at the tiny config (options/tiny.yml), one override per variant
over its network_g and network_motion_estimator (VARIANTS). This file
holds the variants of the motion pass and of the two codebooks;
test_torch_switches_fusion_kp.py the rest, with the same checks.

Weights. A JAX init compiles the generator's training graph, about a
minute per variant on a CPU, so the weights are the port's seeded init put
through tools/convert_reference_checkpoint.py, as a released reference
checkpoint is, then perturbed as in test_torch_models and carried back by
the port's weights.py. The motion estimator's tree is held leaf for leaf
against the shapes of the JAX init (``jax.eval_shape``, which compiles
nothing). The generator's switches only drop modules, so every variant's
JAX generator reads the default's tree (flax ignores the parameters a
module does not use), and which of them a variant has is held by its
state dict against the tools' export. JAX runs un-jitted: once a file's
first variant has compiled its ops, a variant's forwards take a few
seconds, where jitting them compiles for ~30 s.

Tolerances are test_torch_models' (float32 on both sides): 1e-4 for
keypoints and the dense motion, 2e-4 for the generator's outputs; the
commit losses within 1e-4 relative (test_torch_train_parts); the VQ
indices exact. Without MRFA the flow residual is read out by
``to_motion``, from the transformer's tokens through GroupNorms over
one-channel groups, and fed back as the next pass's input three times:
float32 rounding grows along that loop. In the variant without MRFA and
warped-source queries, running each side with float64 weights and inputs
moves its frame by up to 2.6e-4 and pre_final by 5e-4 (each side keeps
float32 islands: the coordinate grid, the attention softmax), and the two
sides differ by as much in either precision. So the generator outputs of
the two variants without MRFA are held at 1e-3 (GEN_TOL); a wrong index,
layout or activation moves them by far more.
"""
import copy
import dataclasses
import functools
import sys
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))

from convert_reference_checkpoint import (  # noqa: E402
    convert_motion_estimator,
    convert_net_g,
    export_motion_estimator,
    export_net_g,
)

from synergize_motion_appearance_tpu import models as jmodels  # noqa: E402
from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build,
)
from synergize_motion_appearance_tpu.models.vqgan import (  # noqa: E402
    VectorQuantizer as JaxVQ,
)
from synergize_motion_appearance_tpu_torch import configs, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch import models as tmodels  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    build_network,
)
from test_torch_models import (  # noqa: E402
    _images,
    _nchw,
    _nhwc,
    _perturb,
    port_nets,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

# The paper's ablations: each a dict of overrides of network_g
# ("g"), the keypoint detector ("kp") or the dense-motion network ("dm").
VARIANTS = {
    "no_position_emb": {"g": {"with_position_emb": False}},
    "no_warp_query": {"g": {"warp_s_d_kp_query": False}},
    "no_mrfa": {"g": {"MRFA_motion_enc": False}},
    "no_warp_query_no_mrfa": {"g": {"warp_s_d_kp_query": False,
                                    "MRFA_motion_enc": False}},
    "whole_motion_book": {"g": {"motion_codebook_split": False}},
    "disjoint_motion_books": {"g": {"wo_motion_cdbk_share": True}},
    "whole_app_book": {"g": {"app_codebook_split": False}},
    "disjoint_app_books": {"g": {"wo_app_cdbk_share": True}},
    "no_sft": {"g": {"multiscale_sft": False}},
    "no_feature_fusion": {"g": {"multiscale_feature_fusion": False}},
    # tiny's 2-stage hourglass cannot feed occlusion_num 5 - 2 direct
    # heads; the flagship's 5 stages can
    "multi_mask": {"dm": {"multi_mask": True, "occlusion_num": 5,
                          "num_blocks": 3}},
    "no_jacobian": {"kp": {"estimate_jacobian": False}},
    "single_jacobian_map": {"kp": {"single_jacobian_map": True}},
}
GEN_TOL = 1e-3  # the generator without MRFA (module docstring)
# this file's variants: the motion pass and the two codebooks
CODEBOOK_VARIANTS = list(VARIANTS)[:8]


def variant_cfg(name, base="tiny"):
    cfg = configs.get(base)
    ov = VARIANTS.get(name, {})
    cfg["network_g"].update(ov.get("g", {}))
    me = cfg["network_motion_estimator"]
    me["kp_detector_params"].update(ov.get("kp", {}))
    me["dense_motion_params"].update(ov.get("dm", {}))
    return cfg


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


SRC = jnp.zeros((1, 64, 64, 3), jnp.float32)
DRV = jnp.zeros((2, 64, 64, 3), jnp.float32)


def _me_kw(cfg):
    me = cfg["network_motion_estimator"]
    kp, dm = me["kp_detector_params"], me["dense_motion_params"]
    return dict(num_blocks_kp=kp["num_blocks"],
                num_blocks_dm=dm["num_blocks"],
                estimate_jacobian=kp.get("estimate_jacobian", True),
                estimate_occlusion=dm.get("estimate_occlusion_map", True),
                multi_mask=dm.get("multi_mask", False),
                occlusion_num=dm.get("occlusion_num", 5),
                scale_factor=dm["scale_factor"])


@functools.lru_cache(maxsize=None)
def _g_vars():
    """The default generator's tree from the port's seeded init, perturbed:
    every variant's generator reads it."""
    cfg = configs.get("tiny")
    g, _ = weights.seeded_nets(cfg, 0)
    g_vars, unused = convert_net_g(
        {k: v.numpy() for k, v in g.state_dict().items()}, cfg["network_g"])
    assert not unused
    return _perturb(g_vars, 2)


def jax_variables(cfg):
    """(g_vars, m_vars) of a variant: the port's seeded init through the
    tools' converter, the motion estimator's shaped as its JAX init,
    perturbed."""
    _, me = weights.seeded_nets(cfg, 0)
    m_vars, unused = convert_motion_estimator(
        {k: v.numpy() for k, v in me.state_dict().items()}, **_me_kw(cfg))
    assert not unused
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    m_shapes = jax.eval_shape(jme.init, jax.random.PRNGKey(0), DRV[:1], SRC)
    assert _shapes(m_vars) == _shapes(m_shapes)
    return _g_vars(), _perturb(m_vars, 3)


def tools_export_g(g_vars, g_cfg):
    """tools' export of a generator tree. The tool maps the two fusions
    of every connected scale whatever the switches say (map_net_g), so the
    entries of a fusion switched off are removed from its export."""
    off = {"multiscale_sft": "fuse_convs_dict.",
           "multiscale_feature_fusion": "fuse_ms_dict."}
    prefixes = tuple(v for k, v in off.items() if not g_cfg.get(k, True))
    sd = export_net_g(g_vars, dict(g_cfg))
    return {k: v for k, v in sd.items() if not k.startswith(prefixes)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _occ_t(occ):
    if isinstance(occ, (list, tuple)):
        return [_nchw(o) for o in occ]
    return _nchw(occ)


def port_dense_motion(dm):
    """The JAX dense motion as the port's generator reads it."""
    return {"deformation": _t(dm["deformation"]),
            "occlusion_map": _occ_t(dm["occlusion_map"]),
            "driving_kp_heatmap": _t(dm["driving_kp_heatmap"])}


# the port's NCHW feature maps among the outputs compared
NCHW = ("out", "pre_final", "out_lr", "occlusion_map", "out_occ")


def _np(tree, nchw=False):
    """JAX arrays and torch tensors as numpy; the port's NCHW maps (under
    the keys NCHW) as NHWC, the JAX layout."""
    if isinstance(tree, dict):
        return {k: _np(v, k in NCHW) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v, nchw) for v in tree]
    if isinstance(tree, torch.Tensor):
        return _nhwc(tree) if nchw else tree.detach().numpy()
    return np.asarray(tree)


TRAIN_KEYS = ("out", "pre_final", "out_lr", "deformation_list",
              "res_deform_list", "motion_recon_list", "out_occ",
              "codebook_loss_motion_list", "codebook_loss_app_list")


@functools.lru_cache(maxsize=None)
def run(name):
    """Both sides of one variant: weights, state dicts, the motion
    estimator (eval mode), the generator's inference call and its
    training forward with gt, with the VQ indices of every quantizer
    call. Everything as numpy."""
    cfg = variant_cfg(name)
    jg = jax_build(dict(cfg["network_g"]))
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    g_vars, m_vars = jax_variables(cfg)
    tg, tme = port_nets(cfg, g_vars, m_vars)
    res = {"cfg": cfg, "sd": {
        "g": (weights.net_g_state_dict(g_vars, cfg["network_g"]),
              tools_export_g(g_vars, cfg["network_g"])),
        "m": (weights.motion_estimator_state_dict(
            m_vars, cfg["network_motion_estimator"]),
            export_motion_estimator(m_vars, **_me_kw(cfg)))}}

    src, drv = _images(2, 40), _images(2, 41)
    jdm = jme.apply(m_vars, jnp.asarray(drv), jnp.asarray(src))
    with torch.no_grad():
        tdm = tme(_nchw(drv), _nchw(src))
    keys = ("deformation", "occlusion_map", "driving_kp_heatmap",
            "kp_driving", "kp_source")
    res["dm"] = (_np({k: tdm[k] for k in keys if k in tdm}),
                 _np({k: jdm[k] for k in keys if k in jdm}))

    dm_t = port_dense_motion(jdm)
    j_inf = jg.apply(g_vars, jnp.asarray(src[:1]), jdm, inference=True)
    with torch.no_grad():
        t_inf = tg(_nchw(src[:1]), dm_t, inference=True)
    res["inference"] = tuple(_np({k: o[k] for k in ("out",
                                                     "deformation_list")})
                             for o in (t_inf, j_inf))

    j_tr, inter = jg.apply(
        g_vars, jnp.asarray(src), jdm, gt=jnp.asarray(drv),
        capture_intermediates=lambda m, _: isinstance(m, JaxVQ))
    indices = {"quantize_motion": [], "quantize_app": []}
    hooks = [getattr(tg, q).register_forward_hook(
        lambda mod, inp, out, q=q: indices[q].append(
            out[2]["min_encoding_indices"])) for q in indices]
    try:
        with torch.no_grad():
            t_tr = tg(_nchw(src), dm_t, gt=_nchw(drv))
    finally:
        for h in hooks:
            h.remove()
    j_idx = {q: [stats["min_encoding_indices"] for _, _, stats in
                 inter["intermediates"][q]["__call__"]] for q in indices}
    res["train"] = (_np({k: t_tr[k] for k in TRAIN_KEYS}),
                    _np({k: j_tr[k] for k in TRAIN_KEYS}))
    res["indices"] = (_np(indices), _np(j_idx))
    return res


def _leaves(tree, path=""):
    """(path, array) of a nested dict / list, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                        f"{path}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}[{i}]")]
    return [(path, np.asarray(tree))]


def _close_tree(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=path)


def _hold_generator(name, got, want):
    """The generator's outputs at 2e-4, or GEN_TOL without MRFA."""
    mrfa = VARIANTS[name].get("g", {}).get("MRFA_motion_enc", True)
    _close_tree(got, want, 2e-4 if mrfa else GEN_TOL)


def check_state_dicts(name):
    """weights.py gives the tools' export, name for name and value for
    value, and the port's networks load it with strict=True (port_nets)."""
    for ours, theirs in run(name)["sd"].values():
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]), err_msg=k)


def check_motion_estimator(name):
    """Keypoints, dense motion and occlusion (eval mode) within 1e-4."""
    got, want = run(name)["dm"]
    _close_tree(got, want, 1e-4)
    kp = VARIANTS[name].get("kp", {})
    assert ("jacobian" in got["kp_driving"]) == kp.get("estimate_jacobian",
                                                       True)
    if VARIANTS[name].get("dm", {}).get("multi_mask"):
        sizes = [o.shape[1] for o in got["occlusion_map"]]
        assert sizes == [4, 8, 16, 32, 64], sizes


def check_generator_inference(name):
    """The inference call's frame and flows, from the same dense motion."""
    _hold_generator(name, *run(name)["inference"])


def check_generator_training_forward(name):
    """out, out_lr, pre_final, the flows, the motion reconstructions and
    out_occ within 2e-4; both commit-loss lists within 1e-4 relative; the
    VQ indices of every quantizer call equal (an offset chunk that read
    other rows would move them)."""
    res = run(name)
    got, want = (dict(t) for t in res["train"])
    for key in ("codebook_loss_motion_list", "codebook_loss_app_list"):
        a, b = got.pop(key), want.pop(key)
        assert len(a) == len(b) == 4, key
        np.testing.assert_allclose(np.array(a, np.float64),
                                   np.array(b, np.float64),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    _hold_generator(name, got, want)
    g_cfg = res["cfg"]["network_g"]
    assert len(got["out_occ"]) == (4 if g_cfg.get("MRFA_motion_enc", True)
                                   and not VARIANTS[name].get("dm") else 0)
    got_idx, want_idx = res["indices"]
    for q in want_idx:
        assert len(got_idx[q]) == len(want_idx[q]) == 4, q
        for a, b in zip(got_idx[q], want_idx[q]):
            np.testing.assert_array_equal(a, b, err_msg=q)


@pytest.mark.parametrize("name", CODEBOOK_VARIANTS)
def test_state_dicts_match_tools_export(name):
    check_state_dicts(name)


@pytest.mark.parametrize("name", CODEBOOK_VARIANTS)
def test_motion_estimator(name):
    check_motion_estimator(name)


@pytest.mark.parametrize("name", CODEBOOK_VARIANTS)
def test_generator_inference(name):
    check_generator_inference(name)


@pytest.mark.parametrize("name", CODEBOOK_VARIANTS)
def test_generator_training_forward(name):
    check_generator_training_forward(name)


def _jax_fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.name not in ("parent", "name")
            and f.default is not dataclasses.MISSING}


def test_build_network_takes_every_jax_key():
    """Every field of the JAX constructors, at its JAX default, builds
    the port's networks, which then equal the networks built without
    them; only the TPU layout keys (wl_*) are dropped."""
    assert not hasattr(tmodels, "_FIXED")
    tiny = configs.get("tiny")
    g_keys = _jax_fields(jmodels.AppMotionCompFormer)
    kp_keys = _jax_fields(jmodels.KPDetector)
    dm_keys = _jax_fields(jmodels.DenseMotionNetwork)
    # the tiny widths win over the JAX defaults
    g_cfg = {**g_keys, **tiny["network_g"]}
    me = copy.deepcopy(tiny["network_motion_estimator"])
    me["kp_detector_params"] = {**kp_keys, **me["kp_detector_params"]}
    me["dense_motion_params"] = {**dm_keys, **me["dense_motion_params"]}
    for key in ("num_kp", "num_channels"):  # common_params carries these
        me["kp_detector_params"].pop(key)
        me["dense_motion_params"].pop(key)
    assert set(g_keys) - set(g_cfg) == set()
    for full, plain in ((g_cfg, tiny["network_g"]),
                        (me, tiny["network_motion_estimator"])):
        with torch.device("meta"):  # structure only
            a, b = build_network(full), build_network(plain)
        assert {k: v.shape for k, v in a.state_dict().items()} == {
            k: v.shape for k, v in b.state_dict().items()}
    with torch.device("meta"):
        for name in ("KPDetector", "DenseMotionNetwork"):
            keys = kp_keys if name == "KPDetector" else dm_keys
            build_network({"type": name, **keys})
