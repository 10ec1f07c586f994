"""The port's ``SRModel`` against the JAX package's, on the CPU: the 32x32
``AutoEncoder`` with nf 8 of tests/test_sr_model.py, three Adam steps of
the L1 pixel loss with EMA 0.99 on an identity target, then ``test``, the
visuals and ``nondist_validation``.

Each step is compared from one state, as tests/test_torch_train_step.py
compares the train step: before it, the JAX model's weights, EMA and Adam
state (count, first and second moments) go through
``weights.network_state_dict`` into the port's model. Both models are
built by ``build_model`` from the same option dict; the JAX one jit-
compiles its step once for the file.

Tolerances, after each step:
- logs: relative 1e-5;
- gradients, recovered on both sides from the Adam first moments as
  g_t = (mu_t - b1 mu_{t-1}) / (1 - b1): over the network 1e-3 relative
  in the 2-norm; per leaf, max |port - JAX| <= 1e-3 * max |JAX leaf| +
  2e-5 * max |JAX network| (the floor is for the leaves whose exact
  gradient is 0, the conv biases in front of a GroupNorm with one channel
  per group, which carry only rounding residue);
- parameters and EMA after the update: within 2 lr everywhere (Adam's
  first steps move an entry by about lr times the sign of its gradient,
  so a gradient near 0 may flip), and within 1e-6 on at least 99.9% of
  the entries whose gradient is above the floor above (Adam moves an
  entry whose gradient is rounding residue by up to lr, in the residue's
  direction).
``test`` on the JAX model's last weights and EMA: within 1e-5 of the
largest output; the PSNR of ``nondist_validation`` within 1e-3 dB.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from synergize_motion_appearance_tpu.model_api import (  # noqa: E402
    build_model as jax_build_model,
)
from synergize_motion_appearance_tpu_torch import weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.model_api import (  # noqa: E402
    build_model,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    AdamState,
)

from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

STEPS = 3
LR = 1e-3
B1 = 0.9


def sr_opt():
    """tests/test_sr_model.py's options."""
    return {
        "model_type": "SRModel",
        "is_train": True,
        "manual_seed": 0,
        "network_g": {
            "type": "AutoEncoder",
            "img_size": 32,
            "nf": 8,
            "ch_mult": [1, 2],
            "res_blocks": 1,
            "attn_resolutions": [8],
            "emb_dim": 16,
        },
        "train": {
            "optim_g": {"type": "Adam", "lr": LR},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "ema_decay": 0.99,
        },
        "val": {"metrics": {"psnr": {"type": "calculate_psnr",
                                     "crop_border": 0}}},
    }


def _sd(tree):
    return weights.network_state_dict({"params": tree},
                                      sr_opt()["network_g"])


def _jax_state(jm):
    """The JAX model's state as port-named numpy arrays (copies: the
    JAX step donates its buffers)."""
    adam = jm.opt_state[0]
    out = {"count": int(np.asarray(adam.count))}
    for name, tree in (("params", jm.params), ("ema", jm.ema_params),
                       ("mu", adam.mu), ("nu", adam.nu)):
        out[name] = {k: v.numpy().copy() for k, v in
                     _sd(jax.tree_util.tree_map(np.array, tree)).items()}
    return out


def _port_state(tm):
    def np_(d):
        return {k: v.detach().numpy().copy() for k, v in d.items()}

    return {"count": tm.adam_state.count,
            "params": np_(dict(tm.net_g.named_parameters())),
            "ema": np_(tm.ema), "mu": np_(tm.adam_state.mu),
            "nu": np_(tm.adam_state.nu)}


def _load(tm, st):
    """The JAX model's state ``st`` into the port's model."""
    def t(d):
        return {k: torch.from_numpy(v.copy()) for k, v in d.items()}

    tm.load_network(t(st["params"]))
    tm.ema = t(st["ema"])
    tm.adam_state = AdamState(st["count"], t(st["mu"]), t(st["nu"]))


def _batch(n, seed):
    lq = np.random.RandomState(seed).rand(n, 32, 32, 3).astype(
        np.float32) * 2 - 1
    return {"lq": lq, "gt": lq.copy()}


@pytest.fixture(scope="module")
def runs():
    jm = jax_build_model(sr_opt())
    tm = build_model(sr_opt(), device="cpu")
    data = _batch(2, 0)
    jm.feed_data(data)
    tm.feed_data(data)
    jm._ensure_state()
    steps = []
    for it in range(1, STEPS + 1):
        before = _jax_state(jm)
        _load(tm, before)
        jm.optimize_parameters(it)
        tm.optimize_parameters(it)
        steps.append({"before": before, "jax": _jax_state(jm),
                      "port": _port_state(tm),
                      "logs": (dict(jm.get_current_log()),
                               dict(tm.get_current_log()))})
    return jm, tm, steps


@pytest.mark.parametrize("i", range(STEPS))
def test_logs(runs, i):
    want, got = runs[2][i]["logs"]
    assert set(got) == set(want) == {"l_pix", "l_total"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_identity_is_learned(runs):
    logs = [s["logs"][1]["l_pix"] for s in runs[2]]
    assert logs[-1] < logs[0]


def _grads(step, side):
    mu0, mu1 = step["before"]["mu"], step[side]["mu"]
    return {k: (mu1[k] - B1 * mu0[k]) / (1 - B1) for k in mu1}


def _floor(grads):
    return 2e-5 * max(np.abs(v).max() for v in grads.values())


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients(runs, i):
    step = runs[2][i]
    assert step["port"]["count"] == step["jax"]["count"] == i + 1
    want, got = _grads(step, "jax"), _grads(step, "port")
    assert set(got) == set(want)
    floor = _floor(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-3 * np.abs(want[k]).max() + floor, (k, err)
    w = np.concatenate([v.ravel() for v in want.values()])
    g = np.concatenate([got[k].ravel() for k in want])
    assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("what", ["params", "ema"])
def test_state_after_update(runs, i, what):
    step = runs[2][i]
    want, got = step["jax"][what], step["port"][what]
    grads = _grads(step, "jax")
    floor = _floor(grads)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * LR * (1 + 1e-3), diffs.max()
    above = np.concatenate([np.abs(grads[k]).ravel() > floor for k in want])
    close = diffs[above] <= 1e-6
    assert close.mean() >= 0.999, 1 - close.mean()


@pytest.fixture(scope="module")
def tested(runs):
    """Both models' test() on the JAX model's last weights and EMA."""
    jm, tm, _ = runs
    _load(tm, _jax_state(jm))
    return np.asarray(jm.test()), tm.test()


def test_test_uses_ema(tested):
    want, got = tested
    assert got.shape == (2, 3, 32, 32)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_visuals(runs, tested):
    jm, tm, _ = runs
    want, got = jm.get_current_visuals(), tm.get_current_visuals()
    assert set(got) == set(want) == {"result", "lq", "gt"}
    for k in want:
        assert got[k].shape == want[k].shape
    np.testing.assert_array_equal(got["lq"], want["lq"])


def test_nondist_validation(runs, tested):
    jm, tm, _ = runs
    loader = [_batch(1, 1), _batch(1, 2)]
    want = jm.nondist_validation(copy.deepcopy(loader), current_iter=STEPS)
    got = tm.nondist_validation(loader, current_iter=STEPS)
    assert set(got) == {"psnr"} and np.isfinite(got["psnr"])
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3, (got, want)
