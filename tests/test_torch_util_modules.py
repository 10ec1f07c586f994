"""The port's remaining utils/ modules and data/augmentation.py against the
JAX package's, on the CPU: MATLAB imresize and the YCbCr conversions
(within 1e-6), grad_layer (within 1e-5) and show_feature_map,
TiledRestorer (equal to JAX's with the same function, and tiles equal to
the whole pass), the clip augmentations (equal under one ``random``
seed), StepTimer against a scripted clock, the torch.profiler trace,
video files, the file client and the lmdb writer (skipped here: lmdb is
not installed).
"""
import json
import random
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu.data import (  # noqa: E402
    augmentation as jaug,
)
from synergize_motion_appearance_tpu.utils import (  # noqa: E402
    file_client as jfc,
    img_util as jimg,
    matlab_functions as jmf,
    profiler as jprof,
    tiled_inference as jtiled,
)
from synergize_motion_appearance_tpu_torch.data import (  # noqa: E402
    augmentation as aug,
)
from synergize_motion_appearance_tpu_torch.utils import (  # noqa: E402
    file_client as fc,
    img_util,
    matlab_functions as mf,
    profiler,
    tiled_inference,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

MATLAB_TOL = 1e-6
GRAD_TOL = 1e-5


# ---------------------------------------------------------- matlab_functions
@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0, 0.75])
@pytest.mark.parametrize("kind", ["float", "uint8", "gray"])
def test_imresize_matches_jax(scale, kind):
    rng = np.random.RandomState(int(scale * 100))
    img = rng.rand(17, 23, 3).astype(np.float32)
    if kind == "uint8":
        img = (img * 255).astype(np.uint8)
    elif kind == "gray":
        img = img[..., 0]
    got, want = mf.imresize(img, scale), jmf.imresize(img, scale)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MATLAB_TOL)


def test_cubic_matches_jax():
    x = np.linspace(-3, 3, 241)
    np.testing.assert_allclose(mf.cubic(x), jmf.cubic(x), rtol=0,
                               atol=MATLAB_TOL)


@pytest.mark.parametrize("uint8", [False, True])
def test_ycbcr_matches_jax(uint8):
    img = np.random.RandomState(1).rand(8, 9, 3).astype(np.float32)
    if uint8:
        img = (img * 255).astype(np.uint8)
    for fn, args in (("rgb2ycbcr", ()), ("rgb2ycbcr", (True,)),
                     ("bgr2ycbcr", ()), ("bgr2ycbcr", (True,)),
                     ("ycbcr2rgb", ())):
        got, want = getattr(mf, fn)(img, *args), getattr(jmf, fn)(img, *args)
        assert got.dtype == want.dtype, fn
        np.testing.assert_allclose(got, want, rtol=0, atol=MATLAB_TOL,
                                   err_msg=fn)


# ------------------------------------------------------------------ img_util
@pytest.mark.parametrize("shape", [(2, 17, 23, 3), (1, 8, 8, 1)])
def test_grad_layer_matches_jax(shape):
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = np.asarray(jimg.grad_layer(x))
    got = img_util.grad_layer(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == shape[:3] + (1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def test_show_feature_map_matches_jax():
    feat = np.random.RandomState(5).randn(2, 6, 7, 4).astype(np.float32)
    want = jimg.show_feature_map(feat)
    np.testing.assert_array_equal(img_util.show_feature_map(feat), want)
    np.testing.assert_array_equal(
        img_util.show_feature_map(torch.from_numpy(feat)), want)


# ------------------------------------------------------------ tiled_inference
def _blur_up(x):
    """3x3 box blur (edge pad) and a x2 nearest upsample, on numpy."""
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(xp[:, i:i + x.shape[1], j:j + x.shape[2]]
               for i in range(3) for j in range(3)) / 9.0
    return blur.repeat(2, axis=1).repeat(2, axis=2)


@pytest.mark.parametrize("kw", [
    dict(tile_size=0), dict(tile_size=16, tile_pad=4),
    dict(tile_size=10, tile_pad=3, pre_pad=2, mod_pad=4)])
def test_tiled_restorer_matches_jax(kw):
    img = np.random.RandomState(2).rand(1, 37, 29, 3).astype(np.float32)
    want = jtiled.TiledRestorer(_blur_up, scale=2, **kw).enhance(img)
    got = tiled_inference.TiledRestorer(
        lambda t: torch.from_numpy(_blur_up(t.numpy())), scale=2,
        device="cpu", **kw).enhance(img)
    assert got.shape == want.shape == (1, 74, 58, 3)
    np.testing.assert_array_equal(got, want)


def test_tiled_grad_layer_equals_whole_pass():
    """grad_layer reaches one pixel, within tile_pad: the stitched tiles
    equal the whole image's pass bit for bit."""
    img = np.random.RandomState(3).rand(2, 70, 54, 3).astype(np.float32)
    whole = tiled_inference.TiledRestorer(
        img_util.grad_layer, device="cpu").enhance(img)
    tiled = tiled_inference.TiledRestorer(
        img_util.grad_layer, tile_size=16, tile_pad=2,
        device="cpu").enhance(img)
    assert tiled.shape == whole.shape == (2, 70, 54, 1)
    np.testing.assert_array_equal(tiled, whole)


# -------------------------------------------------------------- augmentation
def _clip(seed, n=4, h=32, w=28):
    rng = np.random.RandomState(seed)
    return [rng.rand(h, w, 3).astype(np.float32) for _ in range(n)]


AUGMENTATIONS = {
    "flip": ("RandomFlip", dict(time_flip=True, horizontal_flip=True)),
    "resize_nearest": ("RandomResize", dict(ratio=(0.8, 1.2))),
    "resize_linear": ("RandomResize", dict(ratio=(0.8, 1.2),
                                           interpolation="linear")),
    "crop": ("RandomCrop", dict(size=(20, 17))),
    "rotation": ("RandomRotation", dict(degrees=15)),
    "jitter": ("ColorJitter", dict(brightness=0.2, contrast=0.3,
                                   saturation=0.25, hue=0.1)),
    "jitter_no_hue": ("ColorJitter", dict(brightness=0.2, contrast=0.3)),
    "zoom": ("RandomZoom", dict(zoom_range=(0.7, 1.3))),
    "all": ("AllAugmentationTransform", dict(
        flip_param=dict(time_flip=True, horizontal_flip=True),
        rotation_param=dict(degrees=10),
        resize_param=dict(ratio=(0.9, 1.1)),
        crop_param=dict(size=(24, 24)),
        jitter_param=dict(brightness=0.1, contrast=0.1, saturation=0.1,
                          hue=0.1))),
}


@pytest.mark.parametrize("name", sorted(AUGMENTATIONS))
def test_augmentation_matches_jax(name):
    pytest.importorskip("cv2")
    cls, kw = AUGMENTATIONS[name]
    for seed in range(6):
        random.seed(seed)
        want = getattr(jaug, cls)(**kw)(_clip(seed))
        random.seed(seed)
        got = getattr(aug, cls)(**kw)(_clip(seed))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {seed}")


def test_augmentation_names_cv2_when_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for cls, kw in (("RandomResize", {}), ("RandomRotation", dict(degrees=5)),
                    ("RandomZoom", {}), ("ColorJitter", dict(hue=0.1))):
        with pytest.raises(RuntimeError, match="cv2"):
            getattr(aug, cls)(**kw)(_clip(0))
    out = aug.RandomCrop((8, 8))(_clip(0))  # needs no OpenCV
    assert out[0].shape == (8, 8, 3)


# ------------------------------------------------------------------ profiler
class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 2.0, 2.25, 3.0, 3.125, 7.0, 7.5, 8.0]

    def run(mod):
        monkeypatch.setattr(time, "perf_counter", _Clock(ticks))
        timer = mod.StepTimer(ema=0.9)
        seen = []
        for _ in range(4):
            timer.mark_data()
            timer.mark_step()
            seen.append((timer.data_time, timer.step_time, timer.summary()))
        return seen

    got, want = run(profiler), run(jprof)
    assert got == want
    assert got[0][:2] == (0.5, 1.5)


def test_step_timer_syncs_only_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    timer = profiler.StepTimer()
    timer.mark_step(block_on={"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert calls == [] and timer.step_time >= 0


def test_trace_writes_chrome_trace_with_annotation(tmp_path):
    x = torch.randn(64, 64)
    with profiler.trace(str(tmp_path / "logs")):
        with profiler.annotate("frame_batch"):
            y = x @ x
    files = list((tmp_path / "logs").glob("*.pt.trace.json"))
    assert len(files) == 1 and y.shape == (64, 64)
    events = json.loads(files[0].read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "frame_batch"
              and e.get("ph") == "X"]
    assert len(ranges) == 1
    start, end = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    assert any(e.get("ph") == "X" and "mm" in e.get("name", "")
               and start <= e["ts"] <= end for e in events)


# ------------------------------------------------------------ files and video
def test_file_client_disk_matches_jax(tmp_path):
    path = tmp_path / "f.txt"
    path.write_bytes(b"abc\n\x00")
    got, want = fc.FileClient("disk"), jfc.FileClient("disk")
    assert got.get(str(path)) == want.get(str(path)) == b"abc\n\x00"
    path.write_text("line\n")
    assert got.get_text(str(path)) == want.get_text(str(path))
    with pytest.raises(ValueError, match="Backend nfs not supported"):
        fc.FileClient("nfs")


def test_file_client_backends_raise_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(RuntimeError, match="lmdb"):
        fc.FileClient("lmdb", db_paths="x.lmdb")
    with pytest.raises(ImportError, match="memcached"):
        jfc.FileClient("memcached", server_list_cfg="", client_cfg="")
    with pytest.raises(ImportError, match="memcached"):
        fc.FileClient("memcached", server_list_cfg="", client_cfg="")


def test_memcached_backend_raises_the_jax_backends_type():
    """The memcached backend, absent in both packages, raises the same
    exception type in the port as in the JAX package."""
    raised = []
    for mod in (jfc, fc):
        with pytest.raises(Exception) as info:
            mod.MemcachedBackend(server_list_cfg="", client_cfg="")
        raised.append(type(info.value))
    assert raised == [ImportError, ImportError]


def test_video_round_trip_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from synergize_motion_appearance_tpu.utils import video_util as jvideo
    from synergize_motion_appearance_tpu_torch.utils import video_util

    path = str(tmp_path / "clip.mp4")
    rng = np.random.RandomState(6)
    frames = [(rng.rand(32, 48, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    try:
        writer = video_util.VideoWriter(path, height=32, width=48, fps=8)
    except IOError:
        pytest.skip("OpenCV's mp4v writer is unavailable")
    for f in frames:
        writer.write_frame(f)
    writer.close()
    got, want = video_util.VideoReader(path), jvideo.VideoReader(path)
    assert (got.fps, got.width, got.height, len(got)) == (
        want.fps, want.width, want.height, len(want)) == (8, 48, 32, 3)
    read, read_jax = list(got), list(want)
    got.close(), want.close()
    assert len(read) == len(read_jax) == 3
    for a, b, f in zip(read, read_jax, frames):
        np.testing.assert_array_equal(a, b)
        assert abs(float(a.mean()) - float(f.mean())) < 12.0
    assert video_util.has_ffmpeg() == jvideo.has_ffmpeg()


def test_lmdb_make_and_read_back(tmp_path):
    lmdb = pytest.importorskip("lmdb")
    if getattr(lmdb, "__file__", None) is None:
        pytest.skip("lmdb not installed (oracle stub)")
    import cv2

    from synergize_motion_appearance_tpu_torch.utils.lmdb_util import (
        LmdbMaker,
        make_lmdb_from_imgs,
    )

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(4)
    imgs = [(rng.rand(8, 8, 3) * 255).astype(np.uint8) for _ in range(3)]
    for i, img in enumerate(imgs):
        cv2.imwrite(str(img_dir / f"im{i}.png"), img)
    keys = [f"im{i}" for i in range(3)]
    lmdb_path = str(tmp_path / "data.lmdb")
    make_lmdb_from_imgs(str(img_dir), lmdb_path,
                        [f"{k}.png" for k in keys], keys)
    client = fc.FileClient("lmdb", db_paths=[lmdb_path], client_keys=["x"])
    for k, img in zip(keys, imgs):
        buf = client.get(k, "x")
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED),
            img)
    maker = LmdbMaker(str(tmp_path / "m.lmdb"), map_size=1 << 20, batch=2)
    for k, img in zip(keys, imgs):
        maker.put(cv2.imencode(".png", img)[1].tobytes(), k, img.shape)
    maker.close()
    assert (tmp_path / "m.lmdb" / "meta_info.txt").read_text().splitlines(
    ) == [f"{k}.png (8,8,3) 1" for k in keys]
