"""The port's training step against the JAX package's, three steps from the
same state, on the CPU.

The model is ``tiny_opt()`` of tests/test_train_step.py (64x64, float32,
the discriminator from step 2: ``net_d_start_iter`` 1). Before each step
the JAX state goes through the port's weights.py into the port's
``Trainer``, so each step is compared from one state: the two
trajectories would otherwise part within a step or two, since at
initialisation the codebook entries are ~1/K, so the nearest-entry
distances z^2 + e^2 - 2 z.e of an embedding differ only in the last bits
of z^2, and the two frameworks' rounding picks other entries for some
embeddings. Both sides get the same image-like batch and, every step, the
same TPS warp (the one the JAX step draws from its key). One JAX trainer
is built and its step jitted once for the whole file, since its compile
dominates the file's time.

Tolerances, each after every step:
- logs: relative 1e-4 (absolute 1e-6 for the logs that are 0);
- gradients, per leaf: max |port - JAX| <= r * max |JAX leaf| +
  2e-5 * max |JAX network|, and over each network 1e-3 relative in the
  2-norm. r is 1e-3 for the generator and the discriminator. The motion
  networks get r = 2e-3 and 3e-3 in the 2-norm: their float32 gradient is
  ill-conditioned on either side. At step 0 the two float32 gradients lie
  1.1e-3 apart in the 2-norm, and each lies further than that from the
  same step's gradient computed in float64 (the port with every tensor
  in float64), so the difference is float32 rounding, not a fault. Per
  leaf it reaches 1.56e-3 at step 0 on the keypoint detector's hourglass
  convs and their BatchNorm scales (measured; below 5e-4 from step 1 on):
  in front of train-mode BatchNorm a conv's gradient sum(x * dy) cancels
  its input's mean against the zero mean of dy, and keeps ~1e-3 of the
  relative noise.
  The second term is a floor for the leaves whose exact gradient
  is 0 (conv biases in front of a normalisation with per-channel
  statistics: train-mode BatchNorm, and GroupNorm with one channel per
  group at these widths), which carry only rounding residue, up to ~1e-5
  of the network's largest gradient. Gradients are recovered on both
  sides from the Adam first moments, as g_t = (mu_t - b1 mu_{t-1}) /
  (1 - b1), so no second JAX graph is compiled; Adam's step counts must
  agree;
- parameters, BatchNorm statistics and EMA after the update: within
  2 * lr everywhere (Adam's first steps move an entry by about lr times
  the sign of its gradient, so a gradient near 0 may flip), and within
  1e-6 on at least 99.9% of the entries of each network whose gradient
  is above the floor above (Adam moves an entry whose gradient is
  rounding residue by up to lr, in the residue's direction).
The two frameworks sum convolutions in different orders, which leaves
~1e-6 relative noise per layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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

from test_train_step import tiny_opt  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

STEPS = 3
LR = 8e-5
B1 = 0.9


def _batch(n=2, size=64, seed=0):
    """Image-like frames in [-1, 1]: a seeded 8x8 random field, bilinearly
    upsampled, plus a little noise. (White-noise frames blur to nearly
    constant images at the keypoint detector's quarter scale, where
    train-mode BatchNorm then divides rounding noise by ~sqrt(eps).)"""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.uniform(-1, 1, (2 * n, 3, 8, 8)).astype(
        np.float32))
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bilinear").numpy()
    img = np.clip(img + 0.05 * rng.randn(*img.shape), -1, 1)
    img = img.astype(np.float32).transpose(0, 2, 3, 1)
    return {"source": jnp.asarray(img[:n]), "driving": jnp.asarray(img[n:])}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)  # copies


def _jax_named(trainer, jax_state):
    """The JAX state in the port's names: {group: {name: ndarray}}."""
    opt = trainer.opt
    g_cfg, me_cfg = opt["network_g"], opt["network_motion_estimator"]
    n_layers = opt["network_d"]["n_layers"]
    st = jax_state

    def sd(fn, tree, *args):
        return {k: v.numpy() for k, v in fn(tree, *args).items()}

    g = sd(weights.net_g_state_dict, {"params": st.params_g}, g_cfg)
    m = sd(weights.motion_estimator_state_dict,
           {"params": st.params_m, "batch_stats": st.stats_m}, me_cfg)
    d = sd(weights.net_d_state_dict,
           {"params": st.params_d, "batch_stats": st.stats_d}, n_layers)
    out = {"g": g, "m": m, "d": d,
           "ema": sd(weights.net_g_state_dict, {"params": st.ema_g}, g_cfg)}
    for name, o, fn, args, stats in (
            ("g", st.opt_g, weights.net_g_state_dict, (g_cfg,), None),
            ("m", st.opt_m, weights.motion_estimator_state_dict, (me_cfg,),
             st.stats_m),
            ("d", st.opt_d, weights.net_d_state_dict, (n_layers,),
             st.stats_d)):
        for moment in ("mu", "nu"):
            tree = {"params": getattr(o, moment)}
            if stats is not None:
                tree["batch_stats"] = stats
            full = sd(fn, tree, *args)
            out[f"{name}_{moment}"] = {
                k: v for k, v in full.items()
                if k in _param_names(trainer, name)}
        out[f"{name}_count"] = int(np.asarray(o.count))
    return out


def _param_names(trainer, name):
    module = {"g": trainer.net_g, "m": trainer.motion_estimator,
              "d": trainer.net_d}[name]
    return set(dict(module.named_parameters()))


def _port_named(trainer):
    st = trainer.state

    def sd(module):
        return {k: v.detach().numpy().copy()
                for k, v in module.state_dict().items()}

    out = {"g": sd(trainer.net_g), "m": sd(trainer.motion_estimator),
           "d": sd(trainer.net_d),
           "ema": {k: v.numpy().copy() for k, v in st.ema_g.items()}}
    for name, o in (("g", st.opt_g), ("m", st.opt_m), ("d", st.opt_d)):
        out[f"{name}_mu"] = {k: v.numpy().copy() for k, v in o.mu.items()}
        out[f"{name}_nu"] = {k: v.numpy().copy() for k, v in o.nu.items()}
        out[f"{name}_count"] = o.count
    return out


@pytest.fixture(scope="module")
def runs():
    """Both trainers' logs and named states before and after each of
    STEPS steps, each step from the JAX state before it; one JAX init and
    one jitted JAX step."""
    opt = tiny_opt()
    jt = JaxTrainer(opt)
    batch = _batch()
    state, vgg_params = jt.init_state(jax.random.PRNGKey(0), batch)
    step_fn = jax.jit(jt.make_train_step())

    pt = Trainer(opt, device="cpu")
    tbatch = {k: torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2)
                                  .copy()) for k, v in batch.items()}
    tp = opt["train"]["equivariance_opt"]["transform_params"]
    out = {"before": [], "jax": [], "port": [], "jax_logs": [],
           "port_logs": []}
    for i in range(STEPS):
        weights.load_train_state(pt, state, vgg_params)
        out["before"].append(_jax_named(pt, _np_tree(state)))
        rng = jax.random.PRNGKey(i + 1)
        state, logs = step_fn(state, batch, rng, vgg_params)
        tps = jax_sample_tps(jax.random.fold_in(rng, 0), 2,
                             tp["sigma_affine"], tp["sigma_tps"],
                             tp["points_tps"])
        tps = RandomTPSParams(*(torch.from_numpy(np.array(a)) for a in tps))
        plogs = pt.train_step(tbatch, tps=tps)
        out["jax_logs"].append({k: float(v) for k, v in logs.items()})
        out["port_logs"].append({k: float(v) for k, v in plogs.items()})
        out["jax"].append(_jax_named(pt, _np_tree(state)))
        out["port"].append(_port_named(pt))
    return out


STEP_IDS = [f"step{i}" for i in range(STEPS)]


@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_logs(runs, i):
    want, got = runs["jax_logs"][i], runs["port_logs"][i]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-6, (k, got[k], v)


@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_discriminator_gating(runs, i):
    """Steps 0 and 1: D frozen and d_weight 0; step 2 trains it."""
    d_before, d_after = runs["before"][i]["d"], runs["port"][i]["d"]
    moved = any(not np.array_equal(d_before[k], d_after[k])
                for k in d_before if k.endswith("weight"))
    if i < 2:
        assert not moved and runs["port_logs"][i]["d_weight"] == 0.0
        assert runs["port"][i]["d_count"] == 0
    else:
        assert moved and runs["port_logs"][i]["d_weight"] > 0.0
        assert runs["port"][i]["d_count"] == 1


def _grads(runs, side, i, group):
    """Gradients of step i, from the first moments around it, and the
    noise floor of the JAX side's."""
    mu0 = runs["before"][i][f"{group}_mu"]
    mu1 = runs[side][i][f"{group}_mu"]
    return {k: (mu1[k] - B1 * mu0[k]) / (1.0 - B1) for k in mu1}


def _floor(grads):
    return 2e-5 * max(np.abs(w).max() for w in grads.values())


# per-leaf (relative to the leaf's largest gradient) and 2-norm bounds on
# a network's gradient; looser for the motion networks (see the module
# docstring)
LEAF_BOUND = {"g": 1e-3, "m": 2e-3, "d": 1e-3}
NORM_BOUND = {"g": 1e-3, "m": 3e-3, "d": 1e-3}

@pytest.mark.parametrize("group", ["g", "m", "d"])
@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_gradients(runs, i, group):
    assert (runs["port"][i][f"{group}_count"]
            == runs["jax"][i][f"{group}_count"])
    want = _grads(runs, "jax", i, group)
    got = _grads(runs, "port", i, group)
    assert sorted(got) == sorted(want)
    floor = _floor(want)
    for k in want:
        bound = LEAF_BOUND[group] * np.abs(want[k]).max() + floor
        err = np.abs(got[k] - want[k]).max()
        assert err <= bound, (k, err, bound)
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    assert num <= NORM_BOUND[group] ** 2 * den, np.sqrt(num / max(den,
                                                                  1e-30))


@pytest.mark.parametrize("group", ["g", "m", "d", "ema"])
@pytest.mark.parametrize("i", range(STEPS), ids=STEP_IDS)
def test_state_after_update(runs, i, group):
    w, g = runs["jax"][i][group], runs["port"][i][group]
    assert sorted(g) == sorted(w)
    grads = _grads(runs, "jax", i, "g" if group == "ema" else group)
    floor = _floor(grads)
    keys = [k for k in w if not k.endswith("num_batches_tracked")]
    diffs = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in keys])
    # 2 lr, and the rounding of p -+ lr
    assert diffs.max() <= 2 * LR * (1 + 1e-3), (group, diffs.max())
    above = np.concatenate([
        np.abs(grads[k]).ravel() > floor if k in grads
        else np.ones(w[k].size, bool) for k in keys])
    close = diffs[above] <= 1e-6
    assert close.mean() >= 0.999, (group, 1 - close.mean())
