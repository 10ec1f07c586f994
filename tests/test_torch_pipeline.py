"""ReenactmentPipeline.animate: the port against the JAX package at the
tiny config, the same JAX-initialised weights and the same uint8 frames,
with a frame count that is not a multiple of the frame batch (the last
batch is padded), relative motion and hull-area scaling on.

Bounds: in float32 the uint8 frames agree within 1 level, the contract
the JAX package meets against the upstream reference. In bfloat16 both
sides round activations to 8 significant bits, at different places (the
JAX graph runs the motion embedding in float32 by type promotion and
blends warps in bfloat16; the port casts activations to bfloat16 and warps
in float32), and with random weights that rounding moves the JAX package's
own frames several levels from its float32 frames. So the bound is
relative to that drift: the port's bfloat16 frames are no further from the
float32 answer than the JAX package's bfloat16 frames are (plus 1 level),
and the two bfloat16 outputs differ on average by at most twice that
drift, as two independent roundings may.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.inference import (  # noqa: E402
    ReenactmentPipeline as JaxPipeline,
)
from synergize_motion_appearance_tpu_torch import configs  # noqa: E402
from synergize_motion_appearance_tpu_torch.inference import (  # noqa: E402
    ReenactmentPipeline,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention,
)
from test_torch_models import frames, port_nets, tiny_jax_nets  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

N_FRAMES, FRAME_BATCH = 6, 4


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get("tiny")
    jg, jme, g_vars, m_vars = tiny_jax_nets(cfg)
    return cfg, jg, jme, g_vars, m_vars, frames(1, 20), frames(N_FRAMES, 21)


KW = dict(relative=True, adapt_scale=True, frame_batch=FRAME_BATCH,
          u8_io=True)


def _jax_frames(setup, dtype):
    cfg, jg, jme, g_vars, m_vars, src, drv = setup
    out = JaxPipeline(jg, jme, g_vars, m_vars, compute_dtype=dtype,
                      **KW).animate(src, drv)
    return np.asarray(out).astype(np.int32)


def _port_frames(setup, dtype):
    cfg, _, _, g_vars, m_vars, src, drv = setup
    tg, tme = port_nets(cfg, g_vars, m_vars)
    out = ReenactmentPipeline(tg, tme, compute_dtype=dtype, device="cpu",
                              **KW).animate(src, drv)
    assert out.shape == (N_FRAMES, 64, 64, 3)
    assert out.dtype == np.uint8
    return out.astype(np.int32)


@pytest.fixture(scope="module")
def jax_f32(setup):
    return _jax_frames(setup, None)


def test_animate_f32_within_one_level(setup, jax_f32):
    diff = np.abs(_port_frames(setup, None) - jax_f32)
    assert diff.max() <= 1, f"max diff {diff.max()} levels"


def test_animate_bf16_within_bound(setup, jax_f32):
    jax_bf16 = _jax_frames(setup, jnp.bfloat16)
    port_bf16 = _port_frames(setup, torch.bfloat16)
    jax_drift = np.abs(jax_bf16 - jax_f32).mean()
    port_drift = np.abs(port_bf16 - jax_f32).mean()
    between = np.abs(port_bf16 - jax_bf16).mean()
    assert port_drift <= jax_drift + 1.0, (port_drift, jax_drift)
    assert between <= 2.0 * jax_drift, (between, jax_drift)


def test_animate_attention_path_on_cpu(setup):
    """On CPU tensors the pipeline's attention runs the plain version:
    the kernel's launch count does not move."""
    cfg, _, _, g_vars, m_vars, src, drv = setup
    tg, tme = port_nets(cfg, g_vars, m_vars)
    before = fused_attention.launches
    out = ReenactmentPipeline(tg, tme, frame_batch=FRAME_BATCH,
                              compute_dtype=None, device="cpu").animate(
        src.astype(np.float32) / 127.5 - 1.0, drv[:2])
    assert out.dtype == np.float32 and out.shape == (2, 64, 64, 3)
    assert np.isfinite(out).all()
    assert fused_attention.launches == before
