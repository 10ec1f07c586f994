"""The port's training entry point (``train.main`` / ``train.run``), its
checkpoints and ``model_api.AppMotionCompModel``, on the CPU, over a tiny
synthetic frame-folder tree (options/tiny_train.yml at 32x32, float32).

``train.main`` runs 3 steps with validation at step 2 and a checkpoint at
step 3; a second ``main`` resumes from that checkpoint and runs step 4.
The batches each run hands to the trainer are recorded. A ``Trainer``
driven directly with ``train_step`` on those batches, with each step's
generator seeded as the entry point seeds it, must log exactly what the
entry point logged (float32 on the CPU is deterministic: any difference is
a fault, such as validation leaving a network in eval mode). A checkpoint
restored into a fresh ``Trainer`` must equal the saved state bit for bit,
and a step after the restore must equal the uninterrupted step exactly.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from synergize_motion_appearance_tpu_torch import train  # noqa: E402
from synergize_motion_appearance_tpu_torch import training  # noqa: E402
from synergize_motion_appearance_tpu_torch.model_api import (  # noqa: E402
    AppMotionCompModel,
    build_model,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    Trainer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    step_generator,
)
from synergize_motion_appearance_tpu_torch.utils.options import (  # noqa: E402
    parse,
)

from test_train_entry import _opt_file  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

SEED = 0  # options/tiny_train.yml's manual_seed


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/ and val/ folders of two videos of four 32x32 image-like
    frames each (a smooth random field plus noise)."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        for v in range(2):
            d = root / split / f"id{v}#clip0"
            d.mkdir(parents=True)
            for f in range(4):
                low = rng.rand(4, 4, 3).astype(np.float32)
                img = cv2.resize(low, (32, 32), interpolation=cv2.INTER_LINEAR)
                img = np.clip(img + 0.05 * rng.randn(32, 32, 3), 0, 1)
                cv2.imwrite(str(d / f"{f:04d}.png"),
                            (img * 255).astype(np.uint8))
    return root


def _cli_opt(tmp_path, tree):
    """tests/test_train_entry.py's option file (tiny_train.yml at 32x32,
    3 steps, the discriminator from step 2, validation at step 2, a
    checkpoint at step 3), for one process with batch 2, one loader
    worker, and an FID metric, which is not ported and is skipped."""
    path = _opt_file(tmp_path, tree)
    with open(path) as f:
        opt = yaml.safe_load(f)
    ds = opt["datasets"]["train"]
    ds.update(batch_size_per_gpu=2, num_worker_per_gpu=1,
              dataset_enlarge_ratio=2)
    opt["train"]["warmup_iter"] = -1
    opt["val"]["metrics"]["ssim"] = {"type": "calculate_ssim"}
    opt["val"]["metrics"]["fid"] = {"type": "calculate_fid"}
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def _state(tr):
    """Every tensor of a trainer's state, by name, and the Adam counts."""
    st = tr.state
    out = {"step": st.step}
    for name in ("net_g", "motion_estimator", "net_d", "vgg"):
        for k, v in getattr(tr, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().clone()
    for k, v in st.ema_g.items():
        out[f"ema.{k}"] = v.clone()
    for name in ("opt_g", "opt_m", "opt_d"):
        o = getattr(st, name)
        out[f"{name}.count"] = o.count
        for moment in ("mu", "nu"):
            for k, v in getattr(o, moment).items():
                out[f"{name}.{moment}.{k}"] = v.clone()
    return out


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _direct_batch(np_batch):
    """A recorded NHWC numpy batch as train_step's NCHW tensors, converted
    here independently of the entry point."""
    return {k: torch.from_numpy(np_batch[k].copy()).permute(0, 3, 1, 2)
            .contiguous() for k in ("source", "driving")}


def _logs(records):
    return [{k: v for k, v in r.items()
             if k not in ("iter", "epoch", "lrs", "time", "data_time")}
            for r in records]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tree):
    tmp_path = tmp_path_factory.mktemp("cli")
    opt_path = _cli_opt(tmp_path, tree)
    recorded = []
    real = training.batch_to_device

    def recording(batch, device):
        recorded.append({k: v.copy() for k, v in batch.items()})
        return real(batch, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(training, "batch_to_device", recording)
        records = train.main(["-opt", opt_path, "--device", "cpu"])
        first = recorded[:]
        recorded.clear()
        resumed = train.main(["-opt", opt_path, "--device", "cpu",
                              "--steps", "4"])
        second = recorded[:]

    opt = parse(opt_path)
    direct = Trainer(opt, device="cpu", seed=SEED)
    direct_logs = []
    for i, b in enumerate(first):
        logs = direct.train_step(_direct_batch(b),
                                 generator=step_generator(SEED, i, "cpu"))
        direct_logs.append({k: float(v) for k, v in logs.items()})
    after3 = _state(direct)

    restored = Trainer(opt, device="cpu", seed=SEED + 1)  # other weights
    ckpt3 = f"{opt['path']['training_states']}/iter_3"
    epoch3 = restore_checkpoint(ckpt3, restored)
    restored3 = _state(restored)

    step4 = {}
    for name, tr in (("direct", direct), ("restored", restored)):
        logs = tr.train_step(_direct_batch(second[0]),
                             generator=step_generator(SEED, 3, "cpu"))
        step4[name] = {k: float(v) for k, v in logs.items()}
    ckpt4 = Trainer(opt, device="cpu", seed=SEED)
    restore_checkpoint(latest_checkpoint(opt["path"]["training_states"]),
                       ckpt4)
    return {"opt": opt, "records": records, "resumed": resumed,
            "first": first, "second": second, "direct_logs": direct_logs,
            "after3": after3, "restored3": restored3, "ckpt3": ckpt3,
            "epoch3": epoch3, "step4": step4, "direct": _state(direct),
            "restored": _state(restored), "ckpt4": _state(ckpt4)}


def test_entry_point_logs_every_step(runs):
    records = runs["records"]
    assert [r["iter"] for r in records] == [1, 2, 3]
    assert len(runs["first"]) == 3
    for r in records:
        assert r["time"] > 0 and r["data_time"] >= 0
        assert r["lrs"] == [pytest.approx(8e-5)]
        assert all(np.isfinite(v) for v in _logs([r])[0].values())
        assert runs["first"][0]["source"].shape == (2, 32, 32, 3)
    assert records[0]["d_weight"] == 0.0 and records[2]["d_weight"] > 0.0


def test_entry_point_steps_equal_direct_steps(runs):
    """Exactly, in float32 on the CPU, with validation between steps 2
    and 3."""
    assert _logs(runs["records"]) == runs["direct_logs"]


def test_checkpoint_and_validation_files(runs):
    opt = runs["opt"]
    states = opt["path"]["training_states"]
    assert runs["ckpt3"].endswith("iter_3")
    with open(f"{states}/latest") as f:
        assert f.read().strip() == "iter_4"  # the resumed run saved step 4
    with open(f"{opt['path']['log']}/train.log") as f:
        log = f.read()
    assert "Validation @ 2 # psnr" in log and "Validation @ 2 # ssim" in log
    assert "Validation metric fid skipped" in log
    assert "Resumed from" in log


def test_restored_state_is_bit_identical(runs):
    assert runs["epoch3"] == runs["records"][-1]["epoch"]
    _assert_same_state(runs["restored3"], runs["after3"])


def test_step_after_restore_equals_uninterrupted_step(runs):
    assert runs["step4"]["restored"] == runs["step4"]["direct"]
    _assert_same_state(runs["restored"], runs["direct"])


def test_resumed_entry_point_continues_the_run(runs):
    """The second ``main`` resumes at step 3, runs step 4 alone, logs
    what the uninterrupted trainer logs, and saves its state."""
    assert [r["iter"] for r in runs["resumed"]] == [4]
    assert len(runs["second"]) == 1
    assert _logs(runs["resumed"])[0] == runs["step4"]["direct"]
    _assert_same_state(runs["ckpt4"], runs["direct"])


def test_restore_is_strict(tmp_path, runs):
    """A checkpoint of other widths does not load."""
    opt = copy.deepcopy(runs["opt"])
    opt["network_d"]["ndf"] = 4
    tr = Trainer(opt, device="cpu", seed=SEED)
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_checkpoint(runs["ckpt3"], tr)


def test_other_launchers_raise(tmp_path, tree, monkeypatch):
    """--launcher pytorch and slurm need their launcher's variables
    (torchrun's, slurm's): without them each raises before it trains."""
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    opt_path = _cli_opt(tmp_path, tree)
    with pytest.raises(KeyError, match="RANK"):
        train.main(["-opt", opt_path, "--launcher", "pytorch", "--device",
                    "cpu"])
    with pytest.raises(RuntimeError, match="slurm"):
        train.main(["-opt", opt_path, "--launcher", "slurm", "--device",
                    "cpu"])


def test_model_api_round_trip(tmp_path, runs):
    """feed_data / optimize_parameters / save, then a fresh model's
    resume_training: the same state, and the same next step; test() runs
    the EMA generator and leaves every network in train mode."""
    opt = copy.deepcopy(runs["opt"])
    opt["path"]["training_states"] = str(tmp_path / "states")
    a = build_model(opt, device="cpu")
    assert isinstance(a, AppMotionCompModel)
    batches = runs["first"]
    for i in range(2):
        a.feed_data(batches[i])
        a.optimize_parameters(i)
    assert a.trainer.state.step == 2 and a.get_current_log()["l_g_total"] > 0
    path = a.save(epoch=1, current_iter=2)
    b = AppMotionCompModel(opt, device="cpu")
    assert b.resume_training(path) == 1
    _assert_same_state(_state(b.trainer), _state(a.trainer))
    for m in (a, b):
        m.feed_data(batches[2])
        m.optimize_parameters(2)
    assert a.get_current_log() == b.get_current_log()
    out = a.test()
    assert out.shape == (2, 3, 32, 32) and torch.isfinite(out).all()
    vis = a.get_current_visuals()
    assert {k: v.shape for k, v in vis.items()} == {
        k: (2, 32, 32, 3) for k in ("result", "source", "gt")}
    tr = a.trainer
    assert tr.net_g.training and tr.motion_estimator.training \
        and tr.net_d.training


def test_save_checkpoint_points_latest(tmp_path, runs):
    tr = Trainer(runs["opt"], device="cpu", seed=SEED)
    assert latest_checkpoint(str(tmp_path)) is None
    path = save_checkpoint(str(tmp_path), tr, epoch=0)
    assert path.endswith("iter_0") and latest_checkpoint(str(tmp_path)) == path
