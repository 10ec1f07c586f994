"""The generator's telemetry against the JAX package's, on the CPU: the
four lists of JAX ``AppMotionCompFormer.__call__`` (models/
appmotion_former.py:816-933) that the port's forward returns,
``app_before_comp_list`` and ``app_comp_list`` always, and
``deform_feat_list`` and ``app_recon_list`` with ``telemetry=True``.

The tiny config's JAX-initialised nets of tests/test_torch_models.py,
carried across by weights.py; one dense motion of a batch-2 driving
frame; the JAX generator jitted once per mode (training with ``gt``, and
inference). Tolerance 2e-4, absolute and relative, as for the generator's
output (float32 on both sides, convolutions summed in other orders).
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu_torch import configs  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    appmotion_former as amf,
)

from test_torch_models import (  # noqa: E402
    _close, _images, _nchw, _nhwc, port_nets, tiny_jax_nets,
)
from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

TOL = 2e-4
COSTLY = ("deform_feat_list", "app_recon_list")


@pytest.fixture(scope="module")
def run():
    cfg = configs.get("tiny")
    jg, jme, g_vars, m_vars = tiny_jax_nets(cfg)
    tg, _ = port_nets(cfg, g_vars, m_vars)
    src, drv = _images(2, 40), _images(2, 41)
    dm = jax.jit(jme.apply)(m_vars, jnp.asarray(drv), jnp.asarray(src))
    dm_t = {"deformation": torch.from_numpy(np.array(dm["deformation"])),
            "occlusion_map": _nchw(dm["occlusion_map"]),
            "driving_kp_heatmap": torch.from_numpy(
                np.array(dm["driving_kp_heatmap"]))}
    keys = ("app_before_comp_list", "app_comp_list") + COSTLY
    jax_out = {
        "train": jax.jit(lambda v, s, m, g: {
            k: jg.apply(v, s, m, gt=g)[k] for k in keys})(
            g_vars, jnp.asarray(src), dm, jnp.asarray(drv)),
        "inference": jax.jit(lambda v, s, m: {
            k: jg.apply(v, s, m, inference=True)[k] for k in keys[:3]})(
            g_vars, jnp.asarray(src), dm)}
    port = {}
    with torch.no_grad():
        for mode, kw in (("train", {"gt": _nchw(drv)}),
                         ("inference", {"inference": True})):
            for tele in (False, True):
                port[mode, tele] = tg(_nchw(src), dm_t, telemetry=tele, **kw)
    return {"jax": jax_out, "port": port, "net": tg, "src": _nchw(src),
            "drv": _nchw(drv), "dm": dm_t}


def _flat(entries):
    """A list's NHWC arrays, pairs flattened in order."""
    out = []
    for e in entries:
        out += list(e) if isinstance(e, (tuple, list)) else [e]
    return out


@pytest.mark.parametrize("key", ["app_before_comp_list", "app_comp_list",
                                 "deform_feat_list", "app_recon_list"])
def test_training_lists(run, key):
    want = _flat(run["jax"]["train"][key])
    got = _flat(run["port"]["train", True][key])
    assert len(want) == len(got) > 0
    for g, w in zip(got, want):
        _close(_nhwc(g), w, TOL)


@pytest.mark.parametrize("key", ["app_before_comp_list", "app_comp_list",
                                 "deform_feat_list"])
def test_inference_lists(run, key):
    want = _flat(run["jax"]["inference"][key])
    got = _flat(run["port"]["inference", True][key])
    assert len(got) == len(want)
    assert (key == "deform_feat_list") == (len(want) == 0)
    for g, w in zip(got, want):
        _close(_nhwc(g), w, TOL)


def test_lengths_follow_the_scales(run):
    """lq_feat plus one entry per connected scale up to the largest
    appearance scale; deform_feat_list one per connected scale and the
    token grid; app_recon_list one pair per appearance scale."""
    net = run["net"]
    out = run["port"]["train", True]
    n_app = 1 + sum(r <= max(net.connect_app) for r in net.connect)
    assert len(out["app_before_comp_list"]) == len(out["app_comp_list"]) \
        == n_app
    assert len(out["deform_feat_list"]) == 1 + len(net.connect)
    assert len(out["app_recon_list"]) == len(net.connect_app)


@pytest.mark.parametrize("mode", ["train", "inference"])
def test_cheap_lists_need_no_keyword(run, mode):
    """Without the keyword the two cheap lists are returned all the same,
    equal to the telemetry forward's, and so is every frame."""
    plain, tele = run["port"][mode, False], run["port"][mode, True]
    for key in ("app_before_comp_list", "app_comp_list", "out"):
        a, b = _flat(plain[key] if key != "out" else [plain[key]]), _flat(
            tele[key] if key != "out" else [tele[key]])
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not set(COSTLY) & set(plain)


def test_first_entry_enters_compensation(run):
    """app_before_comp_list[0] is the tensor the first appearance
    compensation takes, and app_comp_list[0] is the forward's lq_feat."""
    net = run["net"]
    seen = []
    real = net.app_codebook_compensation

    def spy(feat, motion):
        seen.append(feat)
        return real(feat, motion)

    with torch.no_grad(), mock.patch.object(net, "app_codebook_compensation",
                                            side_effect=spy):
        out = net(run["src"], run["dm"], gt=run["drv"])
    assert out["app_before_comp_list"][0] is seen[0]
    assert out["app_comp_list"][0] is out["lq_feat"]


def test_costly_lists_cost_nothing_without_keyword(run):
    """Without the keyword the training forward warps no detached copy and
    untokens no reconstruction: deform_input and _app_untokens run as
    often as in a forward without telemetry code."""
    net = run["net"]
    counts = {}
    for tele in (False, True):
        with torch.no_grad(), \
                mock.patch.object(amf, "deform_input",
                                  wraps=amf.deform_input) as warp, \
                mock.patch.object(net, "_app_untokens",
                                  wraps=net._app_untokens) as untok:
            net(run["src"], run["dm"], gt=run["drv"], telemetry=tele)
        counts[tele] = (warp.call_count, untok.call_count)
    n_app = len(run["port"]["train", False]["app_comp_list"])
    extra_warps = len(run["port"]["train", True]["deform_feat_list"])
    assert counts[False][1] == n_app
    assert counts[True][0] == counts[False][0] + extra_warps
    assert counts[True][1] == n_app + 2 * len(net.connect_app)
