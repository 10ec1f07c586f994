"""The port's training data pipeline and its helpers against the JAX
package's, on the CPU: option files, the sampler, clip augmentation,
frame-folder dataset items (a synthetic PNG tree), BatchLoader batches,
the native frame cache's bytes and batches, the image converters and
PSNR / SSIM / L1. Each is held equal to the JAX package's on the same
inputs and seeds; the JAX modules used here import no JAX.
"""
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from synergize_motion_appearance_tpu.data import (  # noqa: E402
    BatchLoader as JaxBatchLoader,
    EnlargedSampler as JaxSampler,
    augment_video as jax_augment_video,
    build_dataset as jax_build_dataset,
)
from synergize_motion_appearance_tpu.data import (  # noqa: E402
    native_loader as jax_native,
)
from synergize_motion_appearance_tpu.metrics import (  # noqa: E402
    psnr_ssim as jax_metrics,
)
from synergize_motion_appearance_tpu.utils import (  # noqa: E402
    img_util as jax_img,
    options as jax_options,
)
from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    configs,
    metrics,
)
from synergize_motion_appearance_tpu_torch.data import (  # noqa: E402
    BatchLoader,
    EnlargedSampler,
    augment_video,
    build_dataset,
    native_loader,
)
from synergize_motion_appearance_tpu_torch.metrics import (  # noqa: E402
    psnr_ssim,
)
from synergize_motion_appearance_tpu_torch.utils import (  # noqa: E402
    img_util,
    options,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["train.yml", "tiny_train.yml", "test.yml"])
@pytest.mark.parametrize("is_train", [True, False])
def test_parse_matches_jax(name, is_train):
    path = str(ROOT / "options" / name)
    want = jax_options.parse(path, is_train=is_train)
    got = options.parse(path, is_train=is_train)
    assert got == want
    assert options.dict2str(got) == jax_options.dict2str(want)


def test_parse_resume_state_reuses_experiment(tmp_path):
    import yaml

    opt = yaml.safe_load((ROOT / "options" / "tiny_train.yml").read_text())
    opt["path"]["resume_state"] = str(tmp_path / "exp7" / "training_states"
                                      / "iter_4")
    p = tmp_path / "resume.yml"
    p.write_text(yaml.safe_dump(opt))
    got = options.parse(str(p))
    assert got == jax_options.parse(str(p))
    assert got["name"] == "exp7"
    assert got["path"]["training_states"] == str(tmp_path / "exp7" /
                                                 "training_states")


def test_derive_paths_needs_no_yaml(tmp_path):
    """A Python option dict gets the paths a YAML file would get."""
    opt = configs.get("tiny_train")
    opt["name"] = "from-dict"
    opt["path"] = {"save_path": str(tmp_path)}
    opt = options.derive_paths(opt)
    assert opt["path"]["training_states"] == str(
        tmp_path / "from-dict" / "training_states")
    assert opt["datasets"]["train"]["phase"] == "train"
    options.make_exp_dirs(opt)
    assert (tmp_path / "from-dict" / "training_states").is_dir()


# ---------------------------------------------------------------------------
# sampler, augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,replicas,rank,ratio", [
    (7, 1, 0, 1), (7, 1, 0, 3), (10, 4, 1, 2), (10, 4, 3, 5)])
def test_sampler_matches_jax(n, replicas, rank, ratio):
    a = EnlargedSampler(n, replicas, rank, ratio)
    b = JaxSampler(n, replicas, rank, ratio)
    assert len(a) == len(b)
    for epoch in (0, 1, 5):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rotation", [False, True])
def test_augment_video_matches_jax(seed, rotation):
    clip = [np.random.RandomState(seed + i).rand(5, 7, 3).astype(np.float32)
            for i in range(2)]
    got, s1 = augment_video(clip, rotation=rotation, time_flip=True,
                            return_status=True, rng=random.Random(seed))
    want, s2 = jax_augment_video(clip, rotation=rotation, time_flip=True,
                                 return_status=True, rng=random.Random(seed))
    assert s1 == s2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# frame-folder dataset and loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_tree(tmp_path_factory):
    """train/ and test/ video folders of random PNG frames, 20 x 20, with
    two clips of one identity (name#clip)."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    for split, names in (("train", ["id0#a", "id0#b", "id1#a"]),
                         ("test", ["id2#a"])):
        for name in names:
            d = root / split / name
            d.mkdir(parents=True)
            for f in range(3):
                img = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
                cv2.imwrite(str(d / f"{f:04d}.png"), img)
    return root


def _ds_opt(root, **kw):
    opt = {"type": "FramesMotionTransferDataset", "root_dir": str(root),
           "gt_size": 16, "mean": [0.5] * 3, "std": [0.5] * 3}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("kw", [
    {"id_sampling": False}, {"id_sampling": True},
    {"id_sampling": False, "is_train": False}], ids=["videos", "identities",
                                                      "test"])
def test_dataset_items_match_jax(frame_tree, kw):
    ours = build_dataset(_ds_opt(frame_tree, **kw))
    theirs = jax_build_dataset(_ds_opt(frame_tree, **kw))
    assert ours.videos == theirs.videos
    for idx in range(len(ours)):
        for seed in range(3):
            np.random.seed(seed)
            random.seed(seed)
            a = ours[idx]
            np.random.seed(seed)
            random.seed(seed)
            b = theirs[idx]
            assert sorted(a) == sorted(b) == ["driving", "source"]
            for k in a:
                assert a[k].shape == (16, 16, 3) and a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])


def test_batch_loader_matches_jax(frame_tree):
    """One worker thread, so the global generators are drawn in the
    sampler's order on both sides."""
    def batches(loader_cls, ds_build, sampler_cls):
        ds = ds_build(_ds_opt(frame_tree))
        loader = loader_cls(ds, 2, sampler_cls(len(ds), 1, 0, ratio=3),
                            num_workers=1)
        np.random.seed(3)
        random.seed(3)
        return [b for e in range(2) for b in loader.epoch_iter(e)]

    got = batches(BatchLoader, build_dataset, EnlargedSampler)
    want = batches(JaxBatchLoader, jax_build_dataset, JaxSampler)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        for k in ("source", "driving"):
            assert a[k].shape == (2, 16, 16, 3)
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# native frame cache
# ---------------------------------------------------------------------------

def _videos(seed=0, counts=(3, 5, 2), h=12, w=10):
    rng = np.random.RandomState(seed)
    return [[(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]
            for n in counts]


def _write(write_cache, path, videos, h=12, w=10):
    write_cache(str(path), ((len(v), iter(v)) for v in videos), h, w, 3)


def test_write_cache_bytes_match_jax(tmp_path):
    vids = _videos()
    _write(native_loader.write_cache, tmp_path / "port.fc", vids)
    _write(jax_native.write_cache, tmp_path / "jax.fc", vids)
    assert (tmp_path / "port.fc").read_bytes() == \
        (tmp_path / "jax.fc").read_bytes()
    assert not (tmp_path / "port.fc.payload").exists()


def test_write_cache_rejects_bad_frames(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        _write(native_loader.write_cache, tmp_path / "bad.fc",
               [[np.zeros((12, 10, 3), np.float32)]])


def test_native_library_is_built_under_build(tmp_path):
    path = native_loader.library_path()
    assert path.parent == ROOT / "build" / "native"
    native_loader.load_library()
    assert path.exists()
    # the JAX package's tracked library is never rebuilt by the port
    assert native_loader.SOURCE != ROOT / "native" / "framecache.cpp"


def test_native_batches_match_jax(tmp_path):
    """Same cache, same seed, one worker thread each: the same batches.
    The JAX package's library is built with -march=native, whose fused
    multiply-adds may round the normalization differently in the last
    bit, hence the 1 ulp tolerance (values in [-1, 1])."""
    vids = _videos(seed=1)
    cache = tmp_path / "c.fc"
    _write(native_loader.write_cache, cache, vids)
    try:
        jax_native.load_library()
    except Exception as e:  # the JAX package's own test skips likewise
        pytest.skip(f"JAX package's native library unavailable: {e}")
    ours = native_loader.NativeFrameCacheLoader(str(cache), 4,
                                                num_workers=1, seed=7)
    theirs = jax_native.NativeFrameCacheLoader(str(cache), 4,
                                               num_workers=1, seed=7)
    try:
        assert ours.num_videos == theirs.num_videos == 3
        np.testing.assert_array_equal(ours.get_frame(1, 4), vids[1][4])
        for _ in range(4):
            a, b = ours.next(), theirs.next()
            for k in ("source", "driving"):
                assert a[k].shape == (4, 12, 10, 3)
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-7)
    finally:
        ours.close()
        theirs.close()


def test_cache_from_frame_tree(frame_tree, tmp_path):
    """The cache built from a frame tree holds each frame resized and in
    RGB, as the JAX package's tools/build_framecache.py writes it."""
    dst = tmp_path / "tree.fc"
    n = native_loader.cache_from_frame_tree(str(frame_tree / "train"),
                                            str(dst), 16)
    assert n == 3
    loader = native_loader.NativeFrameCacheLoader(str(dst), 1,
                                                  num_workers=1)
    try:
        png = cv2.imread(str(frame_tree / "train" / "id0#b" / "0002.png"))
        want = cv2.resize(png, (16, 16), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(loader.get_frame(1, 2),
                                      want[..., ::-1])
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# image converters and metrics
# ---------------------------------------------------------------------------

def test_image_converters_match_jax():
    rng = np.random.RandomState(2)
    u8 = (rng.rand(9, 11, 3) * 255).astype(np.uint8)
    for bgr2rgb in (True, False):
        np.testing.assert_array_equal(img_util.img2arr(u8, bgr2rgb),
                                      jax_img.img2arr(u8, bgr2rgb))
    arr = rng.uniform(-1.2, 1.2, (1, 9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(img_util.arr2img(arr),
                                  jax_img.arr2img(arr))


def test_imwrite_imread_round_trip(tmp_path):
    img = (np.random.RandomState(4).rand(6, 5, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "a" / "b.png")
    img_util.imwrite(img, path)
    np.testing.assert_array_equal(img_util.imread(path), img)
    np.testing.assert_array_equal(img_util.imread(path, float32=True),
                                  jax_img.imread(path, float32=True))


@pytest.mark.parametrize("kw", [{}, {"crop_border": 2},
                                {"test_y_channel": True, "crop_border": 1}],
                         ids=["plain", "crop", "y"])
@pytest.mark.parametrize("name", ["calculate_psnr", "calculate_ssim",
                                  "calculate_l1"])
def test_metrics_match_jax(name, kw):
    if name == "calculate_l1":
        kw = {k: v for k, v in kw.items() if k != "test_y_channel"}
    rng = np.random.RandomState(5)
    a = (rng.rand(24, 20, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-20, 20, a.shape), 0,
                255).astype(np.uint8)
    got = metrics.calculate_metric({"img1": a, "img2": b},
                                   {"type": name, **kw})
    want = getattr(jax_metrics, name)(a, b, **kw)
    assert got == want
    assert got == getattr(psnr_ssim, name)(a, b, **kw)


def test_unported_metric_raises_runtime_error(tmp_path, monkeypatch):
    """Every metric is ported now; one whose backbone weights are absent
    raises a RuntimeError that names the file it looked for."""
    monkeypatch.delenv("SAMT_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setenv("SAMT_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(RuntimeError,
                       match="pt_inception-2015-12-05-6726825d.pth"):
        metrics.calculate_metric({"paths": ["a", "b"]},
                                 {"type": "calculate_fid"})


def test_psnr_of_equal_images_is_inf():
    a = np.zeros((4, 4, 3), np.uint8)
    assert metrics.calculate_metric({"img1": a, "img2": a},
                                    {"type": "calculate_psnr"}) == \
        float("inf")
