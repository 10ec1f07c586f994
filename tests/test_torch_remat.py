"""``remat`` in the port's train step, and K3 as the op ``samt::conv3x3``,
on the CPU.

The tiny networks (options/tiny_train.yml's) train under the train block of
options/train_v5e2.yml (the two-chip recipe, ``remat: selective``) in
float32 (its ``compute_dtype`` dropped, so that the three modes may be held
to 1e-6; its perceptual pyramid cut to tiny_train.yml's two scales, which a
64x64 frame allows), with the discriminator from the second step so that
the D phase
and the adaptive weight run inside the rematerialized step. Two steps in
each of ``remat: false``, ``true`` and ``selective`` from one seed and one
batch: the logs, the gradients (as the Adam first moments) and the updated
weights, statistics and EMA agree within 1e-6. Rematerialization recomputes
the same float32 ops in the same order, so they agree bit for bit here.

The checkpoint policy of ``selective`` saves K3's outputs: on the CPU the
op runs its plain version, whose calls show how often the 3x3 convs of the
decoder region ran forward: once per step without remat and with
``selective``, twice with ``true`` (each step's forward plus its
recompute); the input gradients run once per step in every mode.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from synergize_motion_appearance_tpu_torch import configs  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    conv3x3 as k3,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    Trainer,
    step_generator,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    trainer as trainer_mod,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = (False, True, "selective")
STEPS = 2


def v5e2_cfg(remat):
    with open(os.path.join(REPO, "options", "train_v5e2.yml")) as f:
        train = yaml.safe_load(f)["train"]
    cfg = configs.get("tiny_train")
    train.pop("compute_dtype")
    train.update(net_d_start_iter=0, remat=remat,
                 perceptual_opt=cfg["train"]["perceptual_opt"])
    cfg["train"] = train
    return cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32))
    img = torch.nn.functional.interpolate(low, size=(64, 64), mode="bilinear")
    return {"source": img[:2].contiguous(), "driving": img[2:].contiguous()}


@pytest.fixture(scope="module")
def runs():
    out = {}
    real, real_dgrad = k3.conv3x3_reference, k3.conv3x3_input_grad
    for mode in MODES:
        calls = {"all": 0, "input_grad": 0}

        def counting(x, w, b=None):
            calls["all"] += 1
            return real(x, w, b)

        def counting_dgrad(dy, w):
            calls["input_grad"] += 1
            return real_dgrad(dy, w)

        tr = Trainer(v5e2_cfg(mode), device="cpu", seed=0)
        logs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(k3, "conv3x3_reference", counting)
            mp.setattr(k3, "conv3x3_input_grad", counting_dgrad)
            for i in range(STEPS):
                logs.append({k: float(v) for k, v in tr.train_step(
                    _batch(), generator=step_generator(0, i, "cpu")).items()})
        st = tr.state
        out[mode] = {
            "remat": tr.remat, "logs": logs, "calls": calls,
            "tensors": {**{f"g.{k}": v for k, v in
                           tr.net_g.state_dict().items()},
                        **{f"m.{k}": v for k, v in
                           tr.motion_estimator.state_dict().items()},
                        **{f"d.{k}": v for k, v in
                           tr.net_d.state_dict().items()},
                        **{f"ema.{k}": v for k, v in st.ema_g.items()},
                        **{f"{n}.mu.{k}": v
                           for n in ("opt_g", "opt_m", "opt_d")
                           for k, v in getattr(st, n).mu.items()}}}
    return out


def test_train_v5e2_block_loads(runs):
    assert [runs[m]["remat"] for m in MODES] == [False, True, "selective"]
    assert runs["selective"]["logs"][1]["d_weight"] > 0  # the probe ran


@pytest.mark.parametrize("mode", [True, "selective"])
def test_remat_gives_the_same_step(runs, mode):
    base, got = runs[False], runs[mode]
    for a, b in zip(base["logs"], got["logs"]):
        for k, v in a.items():
            assert abs(b[k] - v) <= 1e-6 * max(abs(v), 1.0), (k, b[k], v)
    for k, v in base["tensors"].items():
        assert float((got["tensors"][k].float() - v.float()).abs().max()) \
            <= 1e-6, k


def test_selective_saves_k3_outputs(runs):
    """Calls of K3's plain version per step: forward F and input gradient
    D without remat; 2F + D with ``true``; F + D with ``selective``."""
    dgrad = {m: runs[m]["calls"]["input_grad"] for m in MODES}
    fwd = {m: runs[m]["calls"]["all"] - dgrad[m] for m in MODES}
    assert fwd[False] > 0 and dgrad[False] == fwd[False]
    assert fwd["selective"] == fwd[False]
    assert fwd[True] == 2 * fwd[False]
    assert dgrad[True] == dgrad["selective"] == dgrad[False]


# (gradient values, their other run's values, the difference beyond one
# bf16 ulp): a bf16 value rounded to its other neighbour counts 0, two ulps
# away one, and each element's ulp is that of its own magnitude
GAP_CASES = [
    ([1.0, 96.0], [1.0, 96.5], 0.0),
    ([1.0, 96.0], [1.0, 97.0], 0.5),
    ([-3.0, 0.25], [-3.0, 0.25], 0.0),
    ([3e-3, 1.0], [3e-3 + 2 ** -16, 1.0], 0.0),
    ([3e-3, 1.0], [3e-3 + 2 ** -14, 1.0], 2 ** -14 - 2 ** -16),
]


@pytest.mark.parametrize("case", GAP_CASES, ids=str)
def test_grad_rel_gap(case):
    """chip_smoke.grad_rel_gap, which holds the card's remat modes against
    remat false: relative 2-norm of the gradients behind two Adam first
    moments, whole and beyond one bf16 ulp an element."""
    import chip_smoke

    want, got, beyond = case
    b1 = 0.9
    mu = {k: {"w": torch.tensor(v, dtype=torch.float32) * (1 - b1)}
          for k, v in (("a", got), ("b", want))}
    norm = float(np.linalg.norm(want))
    raw = float(np.linalg.norm(np.subtract(got, want))) / norm
    gap = chip_smoke.grad_rel_gap(torch, mu["a"], mu["b"], b1, True)
    # the moments' float32 round trip (g * 0.1 / 0.1) moves each value by
    # a few float32 ulps
    assert chip_smoke.grad_rel_gap(torch, mu["a"], mu["b"], b1, False) \
        == pytest.approx(raw, rel=1e-4, abs=3e-7)
    assert gap == pytest.approx(beyond / norm, rel=1e-4, abs=3e-7)


def test_parse_remat():
    parse = trainer_mod.parse_remat
    assert parse(False) is False and parse(None) is False
    assert parse(True) is True and parse("selective") == "selective"


# ---------------------------------------------------------------------------
# samt::conv3x3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_opcheck(bias):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 5, 6, generator=gen, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=gen, requires_grad=True)
    b = torch.randn(4, generator=gen, requires_grad=True) if bias else None
    torch.library.opcheck(torch.ops.samt.conv3x3.default, (x, w, b))


def test_conv3x3_op_equals_reference_and_its_gradient():
    """The op against ``conv3x3_reference`` and autograd through it, in
    float64 (exact up to summation order)."""
    gen = torch.Generator().manual_seed(2)
    args = [torch.randn(*s, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for s in ((2, 5, 7, 9), (3, 5, 3, 3), (3,))]
    dy = torch.randn(2, 3, 7, 9, generator=gen, dtype=torch.float64)
    out = k3.conv3x3(*args)
    ref = k3.conv3x3_reference(*args)
    assert torch.allclose(out, ref, rtol=0, atol=1e-12)
    got = torch.autograd.grad(out, args, dy)
    want = torch.autograd.grad(ref, args, dy)
    for g, r in zip(got, want):
        assert torch.allclose(g, r, rtol=0, atol=1e-11)
