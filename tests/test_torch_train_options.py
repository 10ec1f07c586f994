"""The two train-step options the port took last, against the JAX package,
on the CPU: a fixed GAN weight (``use_adaptive_weight: false``) and Adam's
``weight_decay`` (``optax.add_decayed_weights`` chained after
``scale_by_adam``), each optimizer with its own decay.

The second step of ``tiny_opt()`` of tests/test_train_step.py with both
options and ``net_d_start_iter`` -1, so that the GAN term and the
discriminator's update run at every step. The port's ``Trainer`` takes the JAX
state through ``weights.load_train_state`` (whose Adam states are now
chains) and the same batch and TPS warp; one JAX init and one jitted JAX
step for the file. The decays are large (0.25 to 1.0), so that the decay
term lr * wd * p (~1e-6 and more at these weights) shows above the
update bound below.

Tolerances, those of tests/test_torch_train_step.py: logs within 1e-4
relative (1e-6 absolute); gradients per leaf within r times the leaf's
largest plus 2e-5 of the network's largest, and in each network's 2-norm
within 1e-3 (r 1e-3; the motion networks r 2e-3 and the 2-norm 3e-3);
weights, statistics and EMA after the update within 2 lr, and within
1e-6 on 99.9% of the entries whose gradient is above that floor. The
port's ``Adam`` with decay against ``optax.chain(scale_by_adam,
add_decayed_weights)`` on random trees: within 1e-6 of the update's
largest entry, 3 steps.
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from synergize_motion_appearance_tpu.ops import (  # noqa: E402
    sample_random_tps as jax_sample_tps,
)
from synergize_motion_appearance_tpu.training import (  # noqa: E402
    Trainer as JaxTrainer,
)
from synergize_motion_appearance_tpu_torch import configs, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    RandomTPSParams,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    Adam, AdamState, Trainer,
)

from test_torch_train_step import (  # noqa: E402
    LEAF_BOUND, NORM_BOUND, _batch, _jax_named, _np_tree, _port_named,
)
from test_train_step import tiny_opt  # noqa: E402
from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

LR = 8e-5
B1 = 0.9
DECAY = {"optim_g": 0.5, "optim_motion": 0.25, "optim_d": 1.0}


def options_opt():
    opt = tiny_opt()
    t = opt["train"]
    t["use_adaptive_weight"] = False
    t["net_d_start_iter"] = -1
    for name, wd in DECAY.items():
        t[name] = dict(t[name], weight_decay=wd)
    return opt


def _adam_only(state):
    """The JAX state with each optimizer state cut to its scale_by_adam
    part, the layout the shared naming helper reads."""
    return state.replace(**{name: weights._scale_by_adam_state(
        getattr(state, name)) for name in ("opt_g", "opt_m", "opt_d")})


@pytest.fixture(scope="module")
def run():
    """The JAX step from its init, then the compared step: both sides from
    the JAX state after it. (At the init the motion networks' float32
    gradient is at its worst conditioned: tests/test_torch_train_step.py
    measured 1.56e-3 per leaf there, below 5e-4 from the next step on.)"""
    opt = options_opt()
    jt = JaxTrainer(opt)
    batch = _batch()
    state, vgg_params = jt.init_state(jax.random.PRNGKey(0), batch)
    assert isinstance(state.opt_d, tuple) and len(state.opt_d) == 2
    step_fn = jax.jit(jt.make_train_step())
    state, _ = step_fn(state, batch, jax.random.PRNGKey(1), vgg_params)
    pt = Trainer(opt, device="cpu")
    weights.load_train_state(pt, state, vgg_params)
    before = _jax_named(pt, _np_tree(_adam_only(state)))
    rng = jax.random.PRNGKey(2)
    new_state, logs = step_fn(state, batch, rng, vgg_params)
    tp = opt["train"]["equivariance_opt"]["transform_params"]
    tps = jax_sample_tps(jax.random.fold_in(rng, 0), 2, tp["sigma_affine"],
                         tp["sigma_tps"], tp["points_tps"])
    tps = RandomTPSParams(*(torch.from_numpy(np.array(a)) for a in tps))
    tbatch = {k: torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2)
                                  .copy()) for k, v in batch.items()}
    with mock.patch.object(Trainer, "_probe_d_weight",
                           side_effect=AssertionError("probe ran")):
        plogs = pt.train_step(tbatch, tps=tps)
    return {"before": before,
            "jax": _jax_named(pt, _np_tree(_adam_only(new_state))),
            "port": _port_named(pt),
            "jax_logs": {k: float(v) for k, v in logs.items()},
            "port_logs": {k: float(v) for k, v in plogs.items()}}


def test_logs(run):
    want, got = run["jax_logs"], run["port_logs"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-6, (k, got[k], v)


def test_fixed_gan_weight(run):
    """d_weight is scale_adaptive_gan_weight itself, and the GAN term and
    the discriminator's update ran (the probe did not: it is patched to
    raise)."""
    for logs in (run["jax_logs"], run["port_logs"]):
        assert logs["d_weight"] == np.float32(0.8)
        assert logs["l_g_gan"] != 0.0
    assert run["port"]["d_count"] == run["jax"]["d_count"] == 2


def _step_grads(run, side, group):
    mu0 = run["before"][f"{group}_mu"]
    mu1 = run[side][f"{group}_mu"]
    return {k: (mu1[k] - B1 * mu0[k]) / (1.0 - B1) for k in mu1}


def _floor(grads):
    return 2e-5 * max(np.abs(w).max() for w in grads.values())


@pytest.mark.parametrize("group", ["g", "m", "d"])
def test_gradients(run, group):
    want = _step_grads(run, "jax", group)
    got = _step_grads(run, "port", group)
    assert sorted(got) == sorted(want)
    floor = _floor(want)
    for k in want:
        bound = LEAF_BOUND[group] * np.abs(want[k]).max() + floor
        err = np.abs(got[k] - want[k]).max()
        assert err <= bound, (k, err, bound)
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    assert num <= NORM_BOUND[group] ** 2 * den


@pytest.mark.parametrize("group", ["g", "m", "d", "ema"])
def test_state_after_update(run, group):
    w, g = run["jax"][group], run["port"][group]
    assert sorted(g) == sorted(w)
    grads = _step_grads(run, "jax", "g" if group == "ema" else group)
    floor = _floor(grads)
    keys = [k for k in w if not k.endswith("num_batches_tracked")]
    diffs = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in keys])
    assert diffs.max() <= 2 * LR * (1 + 1e-3), (group, diffs.max())
    above = np.concatenate([
        np.abs(grads[k]).ravel() > floor if k in grads
        else np.ones(w[k].size, bool) for k in keys])
    close = diffs[above] <= 1e-6
    assert close.mean() >= 0.999, (group, 1 - close.mean())


@pytest.mark.parametrize("group", ["g", "m", "d"])
def test_decay_shows(run, group):
    """The decay term lr * wd * p is above test_state_after_update's 1e-6
    on more than 1% of the network's weights, ten times the share that
    test lets miss: a step without the decay, or with another
    optimizer's, would fail it."""
    wd = DECAY[{"g": "optim_g", "m": "optim_motion", "d": "optim_d"}[group]]
    p0, p1 = run["before"][group], run["jax"][group]
    names = run["before"][f"{group}_mu"]
    term = np.concatenate([LR * wd * np.abs(p0[k]).ravel() for k in names])
    assert np.mean(term > 1e-6) > 0.01, np.median(term)
    assert any(not np.array_equal(p0[k], p1[k]) for k in names)


@pytest.mark.parametrize("wd", [1e-4, 0.3])
def test_adam_with_decay_matches_optax(wd):
    """The port's Adam against optax.chain(scale_by_adam(b1, b2),
    add_decayed_weights(wd)) then p -= lr * u, three steps on a random
    tree."""
    rng = np.random.RandomState(7)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.99),
                     optax.add_decayed_weights(wd))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    adam = Adam({"betas": [0.9, 0.99], "weight_decay": wd})
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = AdamState.zeros(tp)
    for step in range(3):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        lr = 1e-2 * (step + 1)
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda u: -lr * u, upd))
        adam.step(tstate, tp, {k: torch.from_numpy(v) for k, v in g.items()},
                  lr)
        for k in shapes:
            want = np.asarray(jp[k])
            got = tp[k].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
                1.0, np.abs(want).max()), err_msg=f"step {step} {k}")


def test_options_build_without_raising():
    """Neither option raises any more: the trainer of the tiny option
    dict takes both, every optimizer its own decay."""
    opt = configs.get("tiny_train")
    t = opt["train"]
    t["use_adaptive_weight"] = False
    for name in ("optim_g", "optim_motion", "optim_d"):
        t[name] = dict(t.get(name, t["optim_g"]), weight_decay=1e-4)
    tr = Trainer(opt, device="cpu")
    assert not tr.use_adaptive_weight
    assert all(a.weight_decay == 1e-4
               for a in (tr.adam_g, tr.adam_m, tr.adam_d))
