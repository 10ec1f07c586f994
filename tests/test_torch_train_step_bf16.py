"""The port's bfloat16 mixed-precision training step against the JAX
package's, on the CPU.

``tiny_opt()`` of tests/test_train_step.py with ``compute_dtype:
bfloat16``: the generator and the VGG pyramid run on bfloat16 casts of the
float32 master weights, cast inside the graph; the adaptive GAN weight's
probe runs the discriminator on bfloat16 copies. ``net_d_start_iter`` is 0,
so step 0 has the discriminator gated off and step 1 runs the probe and
the D phase. Each step starts from the JAX state, as in
tests/test_torch_train_step.py, with the same batch and TPS warp on both
sides. One JAX trainer is built and its step jitted once for the file.

Both sides round activations to 8 significant bits, at places that differ
(XLA computes fused elementwise chains in float32 and rounds once; the JAX
graph runs the motion embedding, occlusion and flows in float32 by type
promotion, where the port casts them to bfloat16), and with random weights
that rounding flips nearest codebook entries, so a bfloat16 step lies far
from the float32 one on either side: 17-38% of a network's gradient in
the 2-norm, measured for the JAX package. The bound is therefore relative
to the JAX package's own bfloat16 drift, as for bfloat16 inference in
tests/test_torch_pipeline.py, with the float32 answer taken from the
port's float32 step from the same state (held to the JAX float32 step in
tests/test_torch_train_step.py):
- each network's gradient (2-norm, relative to the float32 gradient):
  the port's bfloat16 drift lies within a factor 2 of the JAX package's,
  either way (so the port rounds where the JAX package does, no more and
  no less), and the two bfloat16 gradients differ by at most twice the
  JAX package's drift, as two independent roundings may;
- each log: the two bfloat16 steps agree within 5e-2 relative to the
  float32 log, the JAX package's own bound between its bfloat16 and
  float32 steps (tests/test_train_step.py::test_bf16_mixed_precision_step),
  plus 5e-3 absolute for the logs that are means of discriminator logits
  near 0 (out_d_*, l_g_gan);
- the port's master weights stay float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from synergize_motion_appearance_tpu.ops import (  # noqa: E402
    sample_random_tps as jax_sample_tps,
)
from synergize_motion_appearance_tpu.training import (  # noqa: E402
    Trainer as JaxTrainer,
)
from synergize_motion_appearance_tpu_torch import weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    RandomTPSParams,
)
from synergize_motion_appearance_tpu_torch.training import Trainer  # noqa: E402

from test_torch_train_step import (  # noqa: E402
    _batch,
    _grads,
    _jax_named,
    _np_tree,
    _port_named,
)
from test_train_step import tiny_opt  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

STEPS = 2
# every log of the tiny train step with D on, in sorted order
LOG_KEYS = sorted([
    "d_weight", "l_d_fake", "l_d_real", "l_equivariance_jacobian",
    "l_equivariance_value", "l_g_app_codebook_code", "l_g_gan",
    "l_g_motion_codebook_code", "l_g_motion_codebook_recon", "l_g_percep",
    "l_g_percep_lr_0", "l_g_pix", "l_g_pix_lr_0", "l_g_total", "l_kpd",
    "out_d_fake", "out_d_real", "step_skipped_nonfinite"])
LOG_REL = 5e-2     # the JAX package's own bf16-vs-f32 bound on a loss
LOG_ABS = 5e-3     # for the means of discriminator logits near 0
DRIFT_FACTOR = 2.0

def _opt(compute_dtype):
    opt = tiny_opt()
    opt["train"]["net_d_start_iter"] = 0
    if compute_dtype is not None:
        opt["train"]["compute_dtype"] = compute_dtype
    return opt


@pytest.fixture(scope="module")
def runs():
    """Per step: the logs and the states after the JAX bfloat16 step, the
    port's bfloat16 step and the port's float32 step, each from the JAX
    state before it; one JAX init and one jitted JAX step."""
    jt = JaxTrainer(_opt("bfloat16"))
    batch = _batch()
    state, vgg_params = jt.init_state(jax.random.PRNGKey(0), batch)
    step_fn = jax.jit(jt.make_train_step())

    ports = {"port": Trainer(_opt("bfloat16"), device="cpu"),
             "f32": Trainer(_opt(None), device="cpu")}
    tbatch = {k: torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2)
                                  .copy()) for k, v in batch.items()}
    tp = _opt(None)["train"]["equivariance_opt"]["transform_params"]
    out = {k: [] for k in ("before", "jax", "port", "f32", "jax_logs",
                           "port_logs", "f32_logs")}
    for i in range(STEPS):
        np_state = _np_tree(state)
        out["before"].append(_jax_named(ports["port"], np_state))
        rng = jax.random.PRNGKey(i + 1)
        state, logs = step_fn(state, batch, rng, vgg_params)
        out["jax_logs"].append({k: float(v) for k, v in logs.items()})
        out["jax"].append(_jax_named(ports["port"], _np_tree(state)))
        tps = jax_sample_tps(jax.random.fold_in(rng, 0), 2,
                             tp["sigma_affine"], tp["sigma_tps"],
                             tp["points_tps"])
        for side, pt in ports.items():
            weights.load_train_state(pt, np_state, vgg_params)
            plogs = pt.train_step(tbatch, tps=RandomTPSParams(
                *(torch.from_numpy(np.array(a)) for a in tps)))
            out[f"{side}_logs"].append({k: float(v)
                                        for k, v in plogs.items()})
            out[side].append(_port_named(pt))
    out["master_dtypes"] = {p.dtype for p in
                            ports["port"].net_g.parameters()}
    return out


STEP_IDS = [f"step{i}" for i in range(STEPS)]


def test_master_weights_stay_float32(runs):
    assert runs["master_dtypes"] == {torch.float32}


@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_logs_within_bf16_drift(runs, i):
    """The logs' keys, finiteness and D's gating; each log's drift is held
    by test_each_log_within_bf16_drift."""
    want = runs["f32_logs"][i]
    jax_bf, port_bf = runs["jax_logs"][i], runs["port_logs"][i]
    assert sorted(port_bf) == sorted(jax_bf) == sorted(want) == LOG_KEYS
    assert port_bf["step_skipped_nonfinite"] == 0.0
    assert all(np.isfinite(v) for v in port_bf.values())
    assert (port_bf["d_weight"] > 0.0) == (jax_bf["d_weight"] > 0.0) == \
        (i > 0)


# One case per step and log, so that a failure names its log. The file has
# one slow fixture and, with a case per step only, few tests: pytest-xdist
# hands out files in order of their test count, most first, so it would
# start last and run alone at the end of the suite.
@pytest.mark.parametrize("key", LOG_KEYS)
@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_each_log_within_bf16_drift(runs, i, key):
    v = runs["f32_logs"][i][key]
    jax_bf, port_bf = runs["jax_logs"][i][key], runs["port_logs"][i][key]
    assert abs(port_bf - jax_bf) <= LOG_REL * abs(v) + LOG_ABS, (
        port_bf, jax_bf, v)


@pytest.mark.parametrize("group", ["g", "m", "d"])
@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_gradients_within_bf16_drift(runs, i, group):
    if group == "d" and i == 0:  # gated off on both sides
        assert runs["port"][i]["d_count"] == runs["jax"][i]["d_count"] == 0
        return
    want = _grads(runs, "f32", i, group)
    jax_bf = _grads(runs, "jax", i, group)
    port_bf = _grads(runs, "port", i, group)

    def dist(a, b):
        return np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in want))

    norm = np.sqrt(sum((want[k] ** 2).sum() for k in want))
    jax_drift = dist(jax_bf, want) / norm
    port_drift = dist(port_bf, want) / norm
    between = dist(port_bf, jax_bf) / norm
    assert jax_drift / DRIFT_FACTOR <= port_drift <= \
        DRIFT_FACTOR * jax_drift, (port_drift, jax_drift)
    assert between <= DRIFT_FACTOR * jax_drift, (between, jax_drift)
