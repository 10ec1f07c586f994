"""Process bodies of tests/test_torch_parallel.py's two-process gloo run on
the CPU, in a module of their own so that a spawned rank imports torch and
the port only (no JAX, no pytest).

``run_ranks`` starts one process per rank with the ``spawn`` method, waits
for them within a timeout, and raises if one fails or hangs (a rank's
traceback goes to its standard error). Each rank writes what the test
checks to ``<out>/rank<r>.pt``.
"""
import os
import socket

import numpy as np
import torch

THREADS = 2  # torch threads per rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _entry(fn, rank, world, args):
    torch.set_num_threads(THREADS)
    fn(rank, world, *args)


def run_ranks(fn, world, args, timeout):
    """``fn(rank, world, *args)`` in ``world`` spawned processes."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(deadline - time.time(), 0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} rank(s) still running after "
                           f"{timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

GLOBAL_BATCH = 4
BN_SHAPE = (GLOBAL_BATCH, 6, 5, 7)


def tiny_train_cfg():
    """options/tiny_train.yml in float32, ``net_d_start_iter`` 1 (the D
    phase and the adaptive weight from the third step)."""
    from synergize_motion_appearance_tpu_torch import configs

    cfg = configs.get("tiny_train")
    cfg["train"]["net_d_start_iter"] = 1
    return cfg


def image_batch(n=GLOBAL_BATCH, size=64, seed=0):
    """(source, driving) pairs of image-like frames in [-1, 1]: a seeded
    8x8 random field, bilinearly upsampled, plus a little noise."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.uniform(-1, 1, (2 * n, 3, 8, 8)).astype(
        np.float32))
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bilinear")
    img = (img + 0.05 * torch.from_numpy(rng.randn(*img.shape).astype(
        np.float32))).clamp(-1, 1)
    return {"source": img[:n].contiguous(), "driving": img[n:].contiguous()}


def bn_inputs():
    """A seeded BatchNorm2d's weights, its input and the output gradient,
    all for the global batch."""
    rng = np.random.RandomState(7)
    C = BN_SHAPE[1]

    def f32(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    return {"weight": 1 + 0.1 * f32(C), "bias": 0.1 * f32(C),
            "running_mean": 0.1 * f32(C),
            "running_var": 1 + 0.1 * f32(C).abs(),
            "x": 0.5 + 2 * f32(*BN_SHAPE), "dy": f32(*BN_SHAPE)}


def bn_step(inp, x):
    """BatchNorm2d in train mode on x, then the backward of sum(y * dy)
    for dy sliced like x: (y, running statistics, dx, dweight, dbias)."""
    from synergize_motion_appearance_tpu_torch.models.layers import (
        BatchNorm2d,
    )

    bn = BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(inp[k])
    x = x.clone().requires_grad_()
    y = bn(x)
    dy = inp["dy"] if x.shape[0] == GLOBAL_BATCH else inp["dy_local"]
    (y * dy).sum().backward()
    return {"y": y.detach(), "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "dx": x.grad,
            "dweight": bn.weight.grad, "dbias": bn.bias.grad}


def train_state(tr):
    """A copy of a trainer's weights, statistics, EMA and Adam states."""
    def copied(tensors):
        return {k: v.detach().clone() for k, v in tensors.items()}

    st = tr.state
    out = {"g": copied(tr.net_g.state_dict()),
           "m": copied(tr.motion_estimator.state_dict()),
           "d": copied(tr.net_d.state_dict()), "ema": copied(st.ema_g)}
    for name, o in (("g", st.opt_g), ("m", st.opt_m), ("d", st.opt_d)):
        out[name + "_count"] = o.count
        out[name + "_mu"], out[name + "_nu"] = copied(o.mu), copied(o.nu)
    return out


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def split_batch_rank(rank, world, port, states_dir, out):
    """(i) BatchNorm2d on this rank's slice of the global batch; (ii) the
    tiny train step on this rank's slice, from each of the one-process
    run's saved states (``<states_dir>/iter_<i>``), with the step's
    generator seeded as the entry point seeds it."""
    from synergize_motion_appearance_tpu_torch.parallel import (
        init_distributed, reset_collectives, shard_batch,
    )
    from synergize_motion_appearance_tpu_torch.parallel import mesh
    from synergize_motion_appearance_tpu_torch.training import (
        Trainer, restore_checkpoint, step_generator,
    )

    info = init_distributed("pytorch", device="cpu",
                            environ=rank_env(rank, world, port))
    assert (info.rank, info.world_size) == (rank, world), info
    result = {}
    inp = bn_inputs()
    local = shard_batch({"x": inp["x"], "dy": inp["dy"]})
    inp["dy_local"] = local["dy"]
    result["bn"] = bn_step(inp, local["x"])

    tr = Trainer(tiny_train_cfg(), device="cpu", seed=1)  # other weights
    batch = shard_batch(image_batch())
    result["steps"] = []
    for i in range(3):
        restore_checkpoint(os.path.join(states_dir, f"iter_{i}"), tr)
        tr.broadcast_state()
        reset_collectives()
        logs = tr.train_step(batch, generator=step_generator(0, i, "cpu"))
        result["steps"].append({
            "logs": {k: float(v) for k, v in logs.items()},
            "state": train_state(tr), "collectives": mesh.collectives,
            "collective_bytes": mesh.collective_bytes})
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def train_cli_rank(rank, world, ports, opt_path, out):
    """``train.main --launcher pytorch --device cpu`` for 2 steps, then a
    second ``main`` that resumes from the step-2 checkpoint and runs step
    3, recording on this rank: the indices its sampler gave in epoch 0,
    what each checkpoint save returned, which checkpoints it restored,
    the logged records, and the trainer's state after each run."""
    from synergize_motion_appearance_tpu_torch import data, train, training

    seen, saved, restored, trainers = [], [], [], []

    class RecordingSampler(data.EnlargedSampler):
        def __iter__(self):
            idx = list(super().__iter__())
            seen.append(idx)
            return iter(idx)

    def saving(*args, **kwargs):
        saved.append(real_save(*args, **kwargs))
        return saved[-1]

    def restoring(path, tr):
        restored.append(os.path.basename(path))
        return real_restore(path, tr)

    class RecordingTrainer(training.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    real_save, real_restore = training.save_checkpoint, \
        training.restore_checkpoint
    data.EnlargedSampler = RecordingSampler
    training.save_checkpoint = saving
    training.restore_checkpoint = restoring
    training.Trainer = RecordingTrainer
    result = {"records": [], "states": []}
    for port, steps in zip(ports, ("2", "3")):
        os.environ.update(rank_env(rank, world, port))
        result["records"].append(train.main(
            ["-opt", opt_path, "--launcher", "pytorch", "--device", "cpu",
             "--steps", steps]))
        result["states"].append(train_state(trainers[-1]))
    result.update(sampler_epoch0=seen[0], saved=saved, restored=restored)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


MODEL_API_STEPS = 2


def model_api_rank(rank, world, port, out):
    """``model_api.AppMotionCompModel`` fed the global batch (NHWC numpy,
    as a loader gives it) beside a ``Trainer`` of the same seed stepped on
    this rank's slice, ``MODEL_API_STEPS`` steps each; then ``test()``,
    the visuals, the trainer's own EMA forward on the slice, and the error
    of an uneven global batch."""
    from synergize_motion_appearance_tpu_torch.model_api import (
        AppMotionCompModel,
    )
    from synergize_motion_appearance_tpu_torch.parallel import (
        init_distributed, shard_batch,
    )
    from synergize_motion_appearance_tpu_torch.training import (
        Trainer, batch_to_device, step_generator,
    )

    init_distributed("pytorch", device="cpu",
                     environ=rank_env(rank, world, port))
    opt = tiny_train_cfg()
    model = AppMotionCompModel(opt, device="cpu")
    tr = Trainer(opt, device="cpu", seed=model.seed)
    global_batch = {k: v.permute(0, 2, 3, 1).numpy()
                    for k, v in image_batch().items()}
    shard = shard_batch(batch_to_device(global_batch, "cpu"))
    result = {"steps": []}
    for i in range(MODEL_API_STEPS):
        model.feed_data(global_batch)
        model.optimize_parameters(i)
        logs = tr.train_step(shard, generator=step_generator(model.seed, i,
                                                             "cpu"))
        result["steps"].append({
            "model_logs": dict(model.get_current_log()),
            "trainer_logs": {k: float(v) for k, v in logs.items()},
            "model": train_state(model.trainer), "trainer": train_state(tr)})
    result["fed"] = {k: v.clone() for k, v in model.batch.items()}
    result["test"] = model.test().clone()
    result["visuals"] = model.get_current_visuals()
    result["local_ema"] = tr.ema_forward(shard["source"], shard["driving"])
    try:
        model.feed_data({k: v[:3] for k, v in global_batch.items()})
    except ValueError as e:
        result["uneven"] = str(e)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
