"""The rest of test_torch_switches' VARIANTS, with its checks and
tolerances: the generator's fusion switches, multi-mask occlusion and the
keypoint detector's Jacobian switches; the two switches that neither
package reads; and the reenactment pipeline (relative motion, the
Jacobian-free normalisation, multi-mask occlusion lists, the anchor
frame) against the JAX package's stages. A file of its own so that the
suite's workers run it beside test_torch_switches.py.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu import inference as jinf  # noqa: E402
from synergize_motion_appearance_tpu_torch.inference import (  # noqa: E402
    ReenactmentPipeline,
    find_best_frame_kp,
)
from test_torch_models import _images, _nchw, frames, port_nets  # noqa: E402
from test_torch_switches import (  # noqa: E402
    CODEBOOK_VARIANTS,
    VARIANTS,
    check_generator_inference,
    check_generator_training_forward,
    check_motion_estimator,
    check_state_dicts,
    jax_build,
    jax_variables,
    port_dense_motion,
    variant_cfg,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

OTHER_VARIANTS = [v for v in VARIANTS if v not in CODEBOOK_VARIANTS]


@pytest.mark.parametrize("name", OTHER_VARIANTS)
def test_state_dicts_match_tools_export(name):
    check_state_dicts(name)


@pytest.mark.parametrize("name", OTHER_VARIANTS)
def test_motion_estimator(name):
    check_motion_estimator(name)


@pytest.mark.parametrize("name", OTHER_VARIANTS)
def test_generator_inference(name):
    check_generator_inference(name)


@pytest.mark.parametrize("name", OTHER_VARIANTS)
def test_generator_training_forward(name):
    check_generator_training_forward(name)


@functools.lru_cache(maxsize=None)
def _generator_outputs(key=None, value=None):
    """The generator's 'out' in its inference call and in its training
    forward, on both sides, with network_g's ``key`` set to ``value``
    (the default without a key)."""
    cfg = variant_cfg(None)
    if key is not None:
        cfg["network_g"][key] = value
    jg = jax_build(dict(cfg["network_g"]))
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    g_vars, m_vars = jax_variables(cfg)
    tg, _ = port_nets(cfg, g_vars, m_vars)
    src, drv = _images(2, 42), _images(2, 43)
    jdm = jme.apply(m_vars, jnp.asarray(drv), jnp.asarray(src))
    dm_t = port_dense_motion(jdm)
    outs = []
    for inference in (True, False):
        gt = None if inference else drv
        outs.append(np.asarray(jg.apply(
            g_vars, jnp.asarray(src), jdm, inference=inference,
            gt=None if gt is None else jnp.asarray(gt))["out"]))
        with torch.no_grad():
            outs.append(tg(_nchw(src), dm_t, inference=inference,
                           gt=None if gt is None else _nchw(gt))["out"]
                        .numpy())
    return outs


@pytest.mark.parametrize("key,value", [("quantizer_type", "gumbel"),
                                       ("detach_motion_query", False)])
def test_switches_without_effect(key, value):
    """Stored and never read on either side: the outputs are the
    default's, bit for bit on each side."""
    for got, want in zip(_generator_outputs(key, value),
                         _generator_outputs()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["multi_mask", "no_jacobian"])
def test_pipeline(name):
    """ReenactmentPipeline.animate (f32, frame batch 2, relative motion
    with hull-area scaling, uint8 frames) against the JAX package's
    stages composed un-jitted per frame batch (normalize_kp_jnp, which
    skips the Jacobian term without Jacobians; the motion estimator; the
    generator): within 1 level; and find_best_frame_kp picks the JAX
    package's frame, the one equal to the source."""
    cfg = variant_cfg(name)
    jg = jax_build(dict(cfg["network_g"]))
    jme = jax_build(dict(cfg["network_motion_estimator"]))
    g_vars, m_vars = jax_variables(cfg)
    tg, tme = port_nets(cfg, g_vars, m_vars)
    src, drv = frames(1, 44), frames(4, 45)
    drv[2] = src[0]
    pipe = ReenactmentPipeline(tg, tme, relative=True, adapt_scale=True,
                               frame_batch=2, compute_dtype=torch.float32,
                               u8_io=True, device="cpu")
    got = pipe.animate(src, drv).astype(np.int32)

    def normalized(u8):
        return jnp.asarray(u8, jnp.float32) * (2.0 / 255.0) - 1.0

    def kp(u8):
        return jme.apply(m_vars, normalized(u8), method="estimate_kp")

    x = normalized(src)
    kp_s, kp_0 = kp(src), kp(drv[:1])
    kp_src = {k: jnp.broadcast_to(v, (2,) + v.shape[1:])
              for k, v in kp_s.items()}
    want = []
    for s in (0, 2):
        kp_n = jinf.normalize_kp_jnp(
            kp_s, kp(drv[s:s + 2]), kp_0, adapt_movement_scale=True,
            use_relative_movement=True, use_relative_jacobian=True)
        dm = jme.apply(m_vars, kp_src, kp_n, x,
                       method="estimate_motion_w_kp")
        out = jg.apply(g_vars, x, dm, inference=True)["out"]
        want.append(np.asarray(jnp.round((jnp.clip(out, -1, 1) + 1)
                                         * 127.5)))
    diff = np.abs(got - np.concatenate(want).astype(np.int32))
    assert diff.max() <= 1, f"max diff {diff.max()} levels"

    jax_pipe = types.SimpleNamespace(
        frame_batch=2, estimate_kp=lambda f: kp(np.asarray(f)))
    assert find_best_frame_kp(pipe, src, drv) == jinf.find_best_frame_kp(
        jax_pipe, src, drv) == 2
