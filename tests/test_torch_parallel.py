"""The port's data-parallel layer (parallel/mesh.py, the global-batch train
step, the launchers of train.py) and frame-parallel inference, on the CPU.

- The slurm rendezvous against the JAX package's functions on the same
  environments (tests/test_dist_launch.py's cases), and
  ``init_distributed``'s no-op and error cases.
- One two-process gloo run (tests/_torch_dist_workers.py; 2 torch threads
  per rank; no JAX in the ranks) on a global batch of 4 split 2 + 2,
  against one process on the whole batch:
  (i) ``BatchNorm2d`` in train mode: outputs, running statistics and input
  gradients within 1e-5 (absolute, on values of order 1; float32 sums in
  another order), the ranks' weight gradients summed within 1e-4;
  (ii) three tiny float32 ``Trainer.train_step``s, ``net_d_start_iter`` 1,
  so the third runs the D phase and the adaptive weight: before each
  step every rank
  restores the one-process run's state before that step, so each step is
  compared from one state (see ``_compare_updates`` for why and for the
  bounds); (iii) the ranks' weights, statistics, EMA and Adam states are
  identical, bit for bit, after every step.
- ``train.main --launcher pytorch --device cpu`` on two ranks over a tiny
  frame tree: 2 steps, then a resumed run to step 3. Only rank 0 writes
  the log file and the checkpoints, the ranks' sampler indices are
  disjoint, both ranks restore the checkpoint and stay identical.
- ``ReenactmentPipeline(mesh=["cpu", "cpu"])`` against ``mesh=None``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_workers as workers  # noqa: E402
from synergize_motion_appearance_tpu_torch import parallel  # noqa: E402
from synergize_motion_appearance_tpu_torch.parallel import mesh  # noqa: E402
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    Trainer,
    save_checkpoint,
    step_generator,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

RANK_TIMEOUT = 240  # seconds for a spawned rank

NODE_LISTS = ["node[003-005,9],extra7", "tpu-host-a,tpu-host-b",
              "solo-node", "gpu[12-13]"]
SLURM_ENVS = [
    ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
      "SLURM_NODELIST": "node[003-005,9],extra7"}, None),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
      "SLURM_NODELIST": "tpu-host-a,tpu-host-b"}, None),
    ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "SLURM_NODELIST": "a[1-2]",
      "MASTER_PORT": "12345"}, None),
    ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "SLURM_NODELIST": "a[1-2]",
      "MASTER_PORT": "12345"}, 777),
]


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_list", NODE_LISTS)
def test_slurm_first_hostname_matches_jax(node_list):
    from synergize_motion_appearance_tpu.parallel import mesh as jax_mesh

    assert mesh._slurm_first_hostname(node_list) == \
        jax_mesh._slurm_first_hostname(node_list)


@pytest.mark.parametrize("env,port", SLURM_ENVS)
def test_slurm_rendezvous_matches_jax(env, port):
    from synergize_motion_appearance_tpu.parallel import mesh as jax_mesh

    got = parallel.slurm_rendezvous(environ=env, port=port)
    assert got == jax_mesh.slurm_rendezvous(environ=env, port=port)
    want_port = port or int(env.get("MASTER_PORT", 29500))
    assert got[0].endswith(f":{want_port}")
    assert got[1:] == (int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]))


@pytest.mark.parametrize("launcher,env", [
    ("none", {}),
    ("slurm", {"SLURM_PROCID": "0", "SLURM_NTASKS": "1",
               "SLURM_NODELIST": "solo-node"}),
])
def test_init_distributed_noop(monkeypatch, launcher, env):
    """One process, or a one-task slurm job, joins no group."""
    called = {}
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda *a, **kw: called.setdefault("init", kw))
    info = parallel.init_distributed(launcher, device="cpu", environ=env)
    assert tuple(info) == (0, 1, 0)
    assert "init" not in called
    assert not parallel.in_process_group()
    assert parallel.get_dist_info() == (0, 1) and parallel.is_master()


def test_init_distributed_slurm_outside_slurm_raises():
    with pytest.raises(RuntimeError, match="slurm"):
        parallel.init_distributed("slurm", device="cpu", environ={})


def test_init_distributed_unknown_launcher_raises():
    with pytest.raises(ValueError, match="launcher"):
        parallel.init_distributed("jax", device="cpu", environ={})


def test_init_distributed_backend_follows_device(monkeypatch):
    """gloo for the CPU, the torchrun variables and the port argument."""
    called = {}
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: called.update(backend=backend,
                                                            **kw))
    env = workers.rank_env(1, 3, 4321)
    info = parallel.init_distributed("pytorch", device="cpu", environ=env,
                                     port=999)
    assert tuple(info) == (1, 3, 1)
    assert called == {"backend": "gloo", "init_method": "tcp://127.0.0.1:999",
                      "rank": 1, "world_size": 3}


def test_shard_batch():
    batch = {"a": torch.arange(6), "b": torch.arange(12).reshape(6, 2)}
    part = parallel.shard_batch(batch, rank=1, world=3)
    assert part["a"].tolist() == [2, 3]
    assert part["b"].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="evenly"):
        parallel.shard_batch(batch, rank=0, world=4)


def test_collectives_are_noops_outside_a_group():
    t = {"x": torch.ones(3)}
    assert parallel.all_reduce_mean(t) is t
    parallel.broadcast_tensors([torch.ones(2)])  # no group: nothing to do
    assert mesh._buckets([torch.ones(2), torch.ones(3),
                          torch.ones(2, dtype=torch.int64)]) == [[0, 1], [2]]


# ---------------------------------------------------------------------------
# the two-process run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_run(tmp_path_factory):
    """The one-process reference on the whole batch (states saved before
    each step), then the two ranks on its halves."""
    tmp = tmp_path_factory.mktemp("split")
    inp = workers.bn_inputs()
    bn_ref = workers.bn_step(inp, inp["x"])
    ref = Trainer(workers.tiny_train_cfg(), device="cpu", seed=0)
    batch = workers.image_batch()
    before, after, logs = [], [], []
    for i in range(3):
        save_checkpoint(str(tmp / "states"), ref)
        before.append(workers.train_state(ref))
        logs.append({k: float(v) for k, v in ref.train_step(
            batch, generator=step_generator(0, i, "cpu")).items()})
        after.append(workers.train_state(ref))
    workers.run_ranks(workers.split_batch_rank, 2,
                      (workers.free_port(), str(tmp / "states"), str(tmp)),
                      RANK_TIMEOUT)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"bn": bn_ref, "before": before, "after": after, "logs": logs,
            "ranks": ranks, "lr": [max(f(i) for f in (ref.lr_g, ref.lr_m,
                                                      ref.lr_d))
                                   for i in range(3)]}


def test_batchnorm_split_batch_equals_whole(split_run):
    ref, ranks = split_run["bn"], [r["bn"] for r in split_run["ranks"]]
    for k in ("y", "dx"):
        got = torch.cat([r[k] for r in ranks])
        assert float((got - ref[k]).abs().max()) <= 1e-5, k
    for k in ("running_mean", "running_var"):
        for r in ranks:
            assert float((r[k] - ref[k]).abs().max()) <= 1e-6, k
    for k in ("dweight", "dbias"):
        got = ranks[0][k] + ranks[1][k]
        assert float((got - ref[k]).abs().max()) <= 1e-4, k


# per leaf: |split - whole| <= r * max |whole leaf| + 2e-5 * max |whole
# network|; over each network 1e-3 relative in the 2-norm. The motion
# networks get r = 2e-3 and 3e-3 in the 2-norm: their float32 gradient is
# ill-conditioned (ROADMAP.md, queue 3), here between two summation orders
# of the same batch.
GRAD_LEAF_BOUND = {"g": 1e-3, "m": 2e-3, "d": 1e-3}
GRAD_NORM_BOUND = {"g": 1e-3, "m": 3e-3, "d": 1e-3}
B1, B2 = 0.9, 0.99


def _rel_norm(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / max(den, 1e-30)) ** 0.5


def _compare_updates(before, whole, split, lr):
    """The split step against the whole-batch step, both from ``before``.
    Why each step starts from one state: at initialisation the codebook
    entries are ~1/K, so the nearest entry to an embedding is decided in
    the last bits of its distances, and the split batch's other summation
    order picks other entries for a few embeddings, after which two
    trajectories part. Gradients are recovered from the Adam first moments
    as (mu_t - b1 mu_{t-1}) / (1 - b1) and held per leaf and per network
    (GRAD_*_BOUND), the second moments' increments at twice the 2-norm
    bound. Weights, statistics and EMA agree within 2 lr everywhere (Adam's
    first steps move an entry by about lr times the sign of its gradient,
    so a gradient near 0 may flip) and within 1e-6 on at least 99.9% of the
    entries whose gradient is above the floor."""
    grads = {}
    for net in ("g", "m", "d"):
        assert split[net + "_count"] == whole[net + "_count"], net
        mu0 = before[net + "_mu"]
        if whole[net + "_count"] == before[net + "_count"]:  # gated off
            for moment in ("_mu", "_nu"):
                for k, v in whole[net + moment].items():
                    assert torch.equal(split[net + moment][k], v), (net, k)
            continue
        g = {side: {k: (st[net + "_mu"][k] - B1 * mu0[k]) / (1 - B1)
                    for k in mu0} for side, st in (("whole", whole),
                                                   ("split", split))}
        grads[net] = g["whole"]
        floor = 2e-5 * max(float(v.abs().max()) for v in g["whole"].values())
        for k, want in g["whole"].items():
            err = float((g["split"][k] - want).abs().max())
            bound = GRAD_LEAF_BOUND[net] * float(want.abs().max()) + floor
            assert err <= bound, (net, k, err, bound)
        assert _rel_norm(g["split"], g["whole"]) <= GRAD_NORM_BOUND[net], net
        dnu = {side: {k: st[net + "_nu"][k] - B2 * before[net + "_nu"][k]
                      for k in mu0} for side, st in (("whole", whole),
                                                     ("split", split))}
        assert _rel_norm(dnu["split"], dnu["whole"]) <= \
            2 * GRAD_NORM_BOUND[net], (net, "nu")
    for group in ("g", "m", "d", "ema"):
        want, got = whole[group], split[group]
        assert sorted(got) == sorted(want), group
        keys = [k for k in want if not k.endswith("num_batches_tracked")]
        for k in want:
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], want[k]), (group, k)
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in keys])
        assert float(diffs.max()) <= 2 * lr * (1 + 1e-3), group
        g = grads.get("g" if group == "ema" else group)
        if g is None:
            assert float(diffs.max()) == 0.0, group
            continue
        floor = 2e-5 * max(float(v.abs().max()) for v in g.values())
        above = torch.cat([g[k].abs().flatten() > floor if k in g
                           else torch.ones(want[k].numel(), dtype=torch.bool)
                           for k in keys])
        close = (diffs[above] <= 1e-6).float().mean()
        assert float(close) >= 0.999, (group, 1 - float(close))


@pytest.mark.parametrize("step", range(3))
def test_split_step_matches_whole_batch_step(split_run, step):
    """Logs within 1e-4 relative (1e-6 absolute): the global means of the
    split step against the whole batch's; then the updates."""
    want = split_run["logs"][step]
    got = split_run["ranks"][0]["steps"][step]["logs"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-6, (k, got[k], v)
    assert (got["d_weight"] > 0) == (step == 2), "the adaptive weight"
    _compare_updates(split_run["before"][step], split_run["after"][step],
                     split_run["ranks"][0]["steps"][step]["state"],
                     split_run["lr"][step])


def test_ranks_identical_after_each_step(split_run):
    r0, r1 = (r["steps"] for r in split_run["ranks"])
    for a, b in zip(r0, r1):
        assert a["logs"] == b["logs"]
        for group, tensors in a["state"].items():
            if isinstance(tensors, dict):
                for k, v in tensors.items():
                    assert torch.equal(v, b["state"][group][k]), (group, k)
            else:
                assert tensors == b["state"][group], group
    # the step's collectives: G + M gradients in 64 MiB buckets, the
    # probe's two gradients, D's gradients and the logs, plus BatchNorm's
    assert all(s["collectives"] > 4 for s in r0)


# ---------------------------------------------------------------------------
# train.main on two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    yaml = pytest.importorskip("yaml")
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.RandomState(0)
    for v in range(4):
        d = root / "train" / f"id{v}#clip0"
        d.mkdir(parents=True)
        for f in range(4):
            low = rng.rand(4, 4, 3).astype(np.float32)
            img = cv2.resize(low, (32, 32), interpolation=cv2.INTER_LINEAR)
            img = np.clip(img + 0.05 * rng.randn(32, 32, 3), 0, 1)
            cv2.imwrite(str(d / f"{f:04d}.png"), (img * 255).astype(np.uint8))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "options", "tiny_train.yml")) as f:
        opt = yaml.safe_load(f)
    opt["name"] = "two-ranks"
    opt["network_g"]["img_size"] = 32
    opt["datasets"]["train"].update(
        root_dir=str(root / "train"), gt_size=32, batch_size_per_gpu=1,
        num_worker_per_gpu=1, dataset_enlarge_ratio=1)
    opt["datasets"].pop("val", None)
    opt.pop("val", None)
    opt["train"].update(net_d_start_iter=1, warmup_iter=-1)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2,
                     "use_tb_logger": False}
    opt["path"] = {"save_path": str(root / "exp")}
    opt_path = root / "opt.yml"
    with open(opt_path, "w") as f:
        yaml.safe_dump(opt, f)
    workers.run_ranks(workers.train_cli_rank, 2,
                      ((workers.free_port(), workers.free_port()),
                       str(opt_path), str(root)), RANK_TIMEOUT)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"ranks": ranks, "exp": root / "exp" / "two-ranks"}


def test_two_rank_cli_writes_once_from_rank_0(cli_run):
    r0, r1 = cli_run["ranks"]
    assert [os.path.basename(p) for p in r0["saved"]] == ["iter_2", "iter_3"]
    assert r1["saved"] == ["", ""]
    states = cli_run["exp"] / "training_states"
    assert sorted(os.listdir(states)) == ["iter_2", "iter_3", "latest"]
    log = (cli_run["exp"] / "train.log").read_text()
    assert log.count("Start training from epoch") == 2  # rank 0, two runs
    assert "world size 2" in log
    for r in (r0, r1):
        assert [[x["iter"] for x in recs] for recs in r["records"]] == \
            [[1, 2], [3]]
    for a, b in zip(r0["records"], r1["records"]):  # global means
        for x, y in zip(a, b):
            for k, v in x.items():
                if k not in ("time", "data_time"):
                    assert y[k] == v, k


def test_two_rank_cli_sampler_shares_are_disjoint(cli_run):
    a, b = (r["sampler_epoch0"] for r in cli_run["ranks"])
    assert len(a) == len(b) == 2
    assert sorted(a + b) == [0, 1, 2, 3]


def test_two_rank_cli_resume_restores_on_both_ranks(cli_run):
    r0, r1 = cli_run["ranks"]
    assert r0["restored"] == r1["restored"] == ["iter_2"]
    for run in range(2):
        a, b = r0["states"][run], r1["states"][run]
        for group, tensors in a.items():
            if isinstance(tensors, dict):
                for k, v in tensors.items():
                    assert torch.equal(v, b[group][k]), (run, group, k)
    assert r0["states"][1]["g_count"] == 3


# ---------------------------------------------------------------------------
# frame parallelism
# ---------------------------------------------------------------------------

def test_frame_parallel_matches_one_device():
    from synergize_motion_appearance_tpu_torch import configs
    from synergize_motion_appearance_tpu_torch.inference import (
        ReenactmentPipeline,
    )
    from synergize_motion_appearance_tpu_torch.weights import seeded_nets

    cfg = configs.get("tiny")
    rng = np.random.RandomState(3)
    src = rng.randint(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    drv = rng.randint(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    kw = dict(relative=True, adapt_scale=True, frame_batch=4, u8_io=True,
              compute_dtype=None, device="cpu")
    outs = {}
    for name, mesh_ in (("one", None), ("two", ["cpu", "cpu"])):
        g, me = seeded_nets(cfg, 0)
        pipe = ReenactmentPipeline(g, me, mesh=mesh_, **kw)
        outs[name] = pipe.animate(src, drv).astype(np.int32)
    assert outs["two"].shape == (6, 64, 64, 3)
    assert np.abs(outs["two"] - outs["one"]).max() <= 1
    with pytest.raises(ValueError, match="evenly"):
        ReenactmentPipeline(*seeded_nets(cfg, 0), frame_batch=3,
                            mesh=["cpu", "cpu"], device="cpu")
