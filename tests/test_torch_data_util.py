"""The port's data/data_util.py, utils/misc.py's path helpers and
utils/env.py against the JAX package's, on the CPU: frame indices, the
paired and lmdb path builders, read_img_seq, the Gaussian kernel, the DUF
downsample (within 1e-5), the inpainting masks (equal under one numpy
seed), scandir / mkdir_and_rename / check_resume and the strict
environment flags. The same inputs, made from a seed, go to both.
"""
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu.data import (  # noqa: E402
    data_util as jdu,
)
from synergize_motion_appearance_tpu.utils import (  # noqa: E402
    env as jenv,
    misc as jmisc,
)
from synergize_motion_appearance_tpu_torch import data  # noqa: E402
from synergize_motion_appearance_tpu_torch.data import (  # noqa: E402
    data_util as du,
)
from synergize_motion_appearance_tpu_torch.utils import (  # noqa: E402
    env,
    misc,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

DUF_TOL = 1e-5


@pytest.mark.parametrize("padding", ["replicate", "reflection",
                                     "reflection_circle", "circle"])
@pytest.mark.parametrize("crt_idx", [0, 1, 5, 98, 99])
def test_frame_indices_match_jax(padding, crt_idx):
    for num_frames in (1, 3, 5, 7):
        assert du.generate_frame_indices(
            crt_idx, 100, num_frames, padding) == jdu.generate_frame_indices(
            crt_idx, 100, num_frames, padding)


def test_frame_indices_errors():
    with pytest.raises(ValueError, match="bogus"):
        du.generate_frame_indices(0, 10, 5, "bogus")
    with pytest.raises(AssertionError):
        du.generate_frame_indices(0, 10, 4)


def test_data_reexports_jax_names():
    from synergize_motion_appearance_tpu import data as jdata

    for name in ("duf_downsample", "generate_frame_indices",
                 "paired_paths_from_folder", "paired_paths_from_lmdb",
                 "paired_paths_from_meta_info_file", "paths_from_folder",
                 "paths_from_lmdb", "read_img_seq"):
        assert hasattr(jdata, name)
        assert getattr(data, name) is getattr(du, name)


@pytest.fixture
def pair_tree(tmp_path):
    """Two folders of empty files (the path builders never open them) and
    two .lmdb folders with a meta_info.txt each."""
    lq, gt = tmp_path / "lq", tmp_path / "gt"
    lq.mkdir(), gt.mkdir()
    for stem in ("b", "a", "c"):
        (gt / f"{stem}.png").write_bytes(b"")
        (lq / f"{stem}x4.png").write_bytes(b"")
    (gt / ".hidden").write_bytes(b"")
    meta = tmp_path / "meta.txt"
    meta.write_text("a.png (4,4,3)\nc.png (4,4,3)\n")
    for name in ("in.lmdb", "gt.lmdb"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "meta_info.txt").write_text(
            "k2.png (8,8,3) 1\nk1.png (8,8,3) 1\n")
    return tmp_path


def test_path_builders_match_jax(pair_tree):
    folders = [str(pair_tree / "lq"), str(pair_tree / "gt")]
    keys = ["lq", "gt"]
    for fn, args in (
            ("paired_paths_from_folder", (folders, keys, "{}x4")),
            ("paired_paths_from_meta_info_file",
             (folders, keys, str(pair_tree / "meta.txt"), "{}x4")),
            ("paired_paths_from_lmdb",
             ([str(pair_tree / "in.lmdb"), str(pair_tree / "gt.lmdb")],
              keys)),
            ("paths_from_folder", (folders[1],)),
            ("paths_from_lmdb", (str(pair_tree / "gt.lmdb"),))):
        got = getattr(du, fn)(*args)
        assert got == getattr(jdu, fn)(*args), fn
        assert got, fn


def test_path_builders_raise_as_jax(pair_tree):
    folders = [str(pair_tree / "lq"), str(pair_tree / "gt")]
    cases = [
        ("paired_paths_from_folder", (folders, ["lq", "gt"], "{}")),
        ("paired_paths_from_folder", (folders[:1], ["lq"], "{}")),
        ("paired_paths_from_lmdb", (folders, ["lq", "gt"])),
        ("paths_from_lmdb", (folders[0],)),
    ]
    for fn, args in cases:
        with pytest.raises(ValueError) as want:
            getattr(jdu, fn)(*args)
        with pytest.raises(ValueError) as got:
            getattr(du, fn)(*args)
        assert str(got.value) == str(want.value), fn


@pytest.mark.parametrize("mod_crop", [False, True])
def test_read_img_seq_matches_jax(tmp_path, mod_crop):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"),
                    (rng.rand(11, 13, 3) * 255).astype(np.uint8))
    got = du.read_img_seq(str(tmp_path), mod_crop, 4)
    np.testing.assert_array_equal(got, jdu.read_img_seq(str(tmp_path),
                                                        mod_crop, 4))
    assert got.shape == ((3, 8, 12, 3) if mod_crop else (3, 11, 13, 3))
    listed = [str(tmp_path / "002.png"), str(tmp_path / "000.png")]
    np.testing.assert_array_equal(du.read_img_seq(listed),
                                  jdu.read_img_seq(listed))


@pytest.mark.parametrize("size,sigma", [(13, 1.6), (13, 0.8), (7, 1.2)])
def test_gaussian_kernel_matches_jax(size, sigma):
    np.testing.assert_array_equal(du.generate_gaussian_kernel(size, sigma),
                                  jdu.generate_gaussian_kernel(size, sigma))


@pytest.mark.parametrize("shape,scale", [
    ((3, 32, 32, 2), 4), ((2, 3, 30, 34, 3), 2), ((2, 2, 33, 27, 3), 3),
    ((2, 7, 64, 64, 3), 4)])
def test_duf_downsample_matches_jax(shape, scale):
    x = np.random.RandomState(sum(shape) + scale).rand(*shape).astype(
        np.float32)
    want = np.asarray(jdu.duf_downsample(x, scale=scale))
    got = du.duf_downsample(torch.from_numpy(x), scale=scale)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DUF_TOL * np.abs(want).max())


def test_duf_downsample_rejects_scale():
    with pytest.raises(ValueError, match="scale"):
        du.duf_downsample(torch.zeros(1, 32, 32, 3), scale=5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ff_mask_matches_jax(seed):
    pytest.importorskip("cv2")
    np.random.seed(seed)
    want = jdu.random_ff_mask((256, 224))
    np.random.seed(seed)
    got = du.random_ff_mask((256, 224))
    assert got.dtype == np.float32 and got.shape == (256, 224)
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_brush_stroke_mask_matches_jax(seed):
    pytest.importorskip("PIL")
    from PIL import Image

    np.random.seed(seed)
    want = np.asarray(jdu.brush_stroke_mask(Image.new("RGB", (64, 48), 0)))
    np.random.seed(seed)
    got = np.asarray(du.brush_stroke_mask(Image.new("RGB", (64, 48), 0)))
    np.testing.assert_array_equal(got, want)
    assert got.max() == 255


def test_optional_packages_named_when_absent(monkeypatch):
    for name in ("cv2", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(RuntimeError, match="cv2"):
        du.random_ff_mask((8, 8))
    with pytest.raises(RuntimeError, match="cv2"):
        du.read_img_seq(["x.png"])
    with pytest.raises(RuntimeError, match="PIL"):
        du.brush_stroke_mask(None)


# ------------------------------------------------------------- utils/misc
def _tree(root):
    (root / "sub" / "deep").mkdir(parents=True)
    for rel in ("a.png", "b.jpg", ".hidden.png", "sub/c.png",
                "sub/deep/d.jpg", "sub/e.txt"):
        (root / rel).write_bytes(b"")


@pytest.mark.parametrize("suffix", [None, ".png", (".png", ".jpg")])
@pytest.mark.parametrize("recursive", [False, True])
@pytest.mark.parametrize("full_path", [False, True])
def test_scandir_matches_jax(tmp_path, suffix, recursive, full_path):
    _tree(tmp_path)
    got = sorted(misc.scandir(str(tmp_path), suffix, recursive, full_path))
    assert got == sorted(jmisc.scandir(str(tmp_path), suffix, recursive,
                                       full_path))
    assert got


def test_scandir_rejects_suffix():
    with pytest.raises(TypeError, match="suffix"):
        misc.scandir(".", suffix=3)


def test_mkdir_and_rename(tmp_path):
    path = str(tmp_path / "exp")
    misc.mkdir_and_rename(path)
    assert os.path.isdir(path)
    (tmp_path / "exp" / "f").write_text("x")
    misc.mkdir_and_rename(path)
    archived = [p for p in os.listdir(tmp_path) if p != "exp"]
    assert len(archived) == 1
    assert re.fullmatch(r"exp_archived_\d{8}_\d{6}", archived[0])
    assert (tmp_path / archived[0] / "f").read_text() == "x"
    assert os.listdir(path) == []
    assert re.fullmatch(r"\d{8}_\d{6}", misc.get_time_str())


@pytest.mark.parametrize("resume", [None, "exp/training_states/7.state"])
def test_check_resume_matches_jax(resume):
    def opt():
        return {"network_g": {}, "network_d": {}, "train": {},
                "path": {"resume_state": resume, "models": "exp/models"}}

    got, want = opt(), opt()
    misc.check_resume(got, 7)
    jmisc.check_resume(want, 7)
    assert got == want


# ---------------------------------------------------------------- utils/env
@pytest.mark.parametrize("raw", [None, "1", "true", " Yes ", "ON", "0",
                                 "false", "No", "off", "", "flase", "2"])
def test_env_flags_match_jax(monkeypatch, raw):
    name = "SAMT_TEST_PORT_FLAG"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)

    def outcome(mod, *args):
        try:
            return mod(name, *args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(env.env_flag) == outcome(jenv.env_flag)
    for default in (False, True):
        assert outcome(env.env_flag_default, default) == outcome(
            jenv.env_flag_default, default)
