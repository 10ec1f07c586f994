"""``model_api.AppMotionCompModel`` over a process group, on the CPU: the
counterpart of the JAX model API over its ``("data",)`` mesh (JAX
model_api.py:34-52), which shards the global batch it is fed.

Two gloo ranks (tests/_torch_dist_workers.py, 2 torch threads each), the
tiny float32 train config: each rank feeds the model the global batch of
4 and steps a ``Trainer`` of the same seed on its slice of 2 beside it.
Both run one code path, the trainer's global-batch step, so they must
agree bit for bit; ``test()`` and the visuals give the global batch on
both ranks, in rank order; a batch of 3 raises. Outside a process group
the model keeps the whole batch, as before.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_workers as workers  # noqa: E402

from synergize_motion_appearance_tpu_torch.model_api import (  # noqa: E402
    AppMotionCompModel,
)
from synergize_motion_appearance_tpu_torch.parallel import (  # noqa: E402
    gather_batch,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

RANK_TIMEOUT = 240  # seconds for a spawned rank


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_api")
    workers.run_ranks(workers.model_api_rank, 2,
                      (workers.free_port(), str(tmp)), RANK_TIMEOUT)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("step", range(workers.MODEL_API_STEPS))
def test_model_step_equals_trainer_step(ranks, rank, step):
    """Weights, statistics, EMA and Adam states bit for bit, and the logs
    (the global means) equal."""
    st = ranks[rank]["steps"][step]
    assert _equal(st["model"], st["trainer"])
    assert st["model_logs"] == st["trainer_logs"]
    assert st["model_logs"]["d_weight"] == 0.0  # D from the third step


def test_ranks_agree(ranks):
    for a, b in zip(*(r["steps"] for r in ranks)):
        assert _equal(a["model"], b["model"])
        assert a["model_logs"] == b["model_logs"]


def test_feed_data_keeps_the_ranks_slice(ranks):
    whole = workers.image_batch()
    for r, res in enumerate(ranks):
        for k in ("source", "driving"):
            assert torch.equal(res["fed"][k], whole[k][2 * r:2 * r + 2])


def test_test_returns_the_global_batch(ranks):
    """test() on each rank: the two ranks' EMA forwards on their slices,
    in rank order; the visuals hold the global batch too."""
    want = torch.cat([r["local_ema"] for r in ranks])
    whole = workers.image_batch()
    for res in ranks:
        assert res["test"].shape == (workers.GLOBAL_BATCH, 3, 64, 64)
        assert torch.equal(res["test"], want)
        vis = res["visuals"]
        np.testing.assert_array_equal(
            vis["result"], want.permute(0, 2, 3, 1).numpy())
        for key, name in (("source", "source"), ("gt", "driving")):
            np.testing.assert_array_equal(
                vis[key], whole[name].permute(0, 2, 3, 1).numpy())


def test_uneven_global_batch_raises(ranks):
    for res in ranks:
        assert "does not split evenly across 2 ranks" in res["uneven"]


def test_outside_a_group_the_batch_is_whole():
    """No process group: feed_data keeps the whole batch, gather_batch is
    the identity, and test() runs on it."""
    model = AppMotionCompModel(workers.tiny_train_cfg(), device="cpu")
    batch = {k: v[:3].permute(0, 2, 3, 1).numpy()
             for k, v in workers.image_batch().items()}
    model.feed_data(batch)
    assert model.batch["source"].shape == (3, 3, 64, 64)
    out = model.test()
    assert gather_batch(out) is out
    assert model.get_current_visuals()["gt"].shape == (3, 64, 64, 3)
