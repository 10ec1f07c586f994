"""The port's evaluation entry points against the JAX package's, on the
CPU: the two CSV pair datasets on a synthetic image tree (read with the
standard library's csv, where the JAX package reads pandas), and
``test.main`` and ``animate.main`` on a tiny option file, both sides
loading the same weights: the port's seeded ones, put through
tools/convert_reference_checkpoint.py as a released checkpoint would be
(the port reads the .npz files; the JAX entry point gets the converted
variables).

Bounds: the datasets are equal item for item. Both entry points write
the same files. test.py runs float32, so its result PNGs are within 1
uint8 level of the JAX package's; animate.py runs the pipeline's default
bfloat16 on both sides, whose frames differ by the two frameworks'
bfloat16 roundings (tests/test_torch_pipeline.py), so only its files are
compared. The logged PSNR/SSIM/L1 equal the metrics computed directly
from the written result and driving PNGs (PNG is lossless).
"""
import csv
import logging
import os
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")
pytest.importorskip("pandas")

from synergize_motion_appearance_tpu import animate as jax_animate  # noqa: E402
from synergize_motion_appearance_tpu import test as jax_test  # noqa: E402
from synergize_motion_appearance_tpu.data import (  # noqa: E402
    build_dataset as jax_build_dataset,
)
from synergize_motion_appearance_tpu_torch import animate  # noqa: E402
from synergize_motion_appearance_tpu_torch import test as port_test  # noqa: E402
from synergize_motion_appearance_tpu_torch.data import (  # noqa: E402
    build_dataset,
)
from synergize_motion_appearance_tpu_torch.data.frames_dataset import (  # noqa: E402
    read_pairs,
)
from synergize_motion_appearance_tpu_torch.metrics import (  # noqa: E402
    calculate_l1,
    calculate_psnr,
    calculate_ssim,
)
from synergize_motion_appearance_tpu_torch.utils.img_util import (  # noqa: E402
    mimsave,
)
from test_torch_demo_cli import converted_tiny_nets, save_npz  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """frames/<id>/<n>.png images (48x48, resized to 64 by the datasets),
    a driving frame folder, a driving gif, and the two pairs lists."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for vid in ("id0", "id1"):
        (root / "frames" / vid).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(root / "frames" / vid / f"{i:04d}.png"),
                        (rng.rand(48, 48, 3) * 255).astype(np.uint8))
    base = (rng.rand(80, 80, 3) * 255).astype(np.uint8)
    mimsave([base[i:i + 64, i:i + 64, ::-1] for i in range(4)],
            str(root / "drive1.gif"), fps=5)
    with open(root / "pairs.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["source", "driving"])
        w.writerow(["frames/id0/0000.png", "frames/id1/0002.png"])
        w.writerow(["frames/id1/0001.png", "frames/id0/0000.png"])
    with open(root / "videos.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["source", "driving", "anchor_idx"])
        w.writerow(["frames/id0/0001.png", "frames/id1", 1])
        w.writerow(["frames/id1", "drive1.gif", 2])
    return root


def _ds_opt(tree, kind):
    if kind == "pairs":
        return dict(type="FramesMotionTransferTestDataset_PairsList",
                    root_dir=str(tree), pairs_list=str(tree / "pairs.csv"),
                    gt_size=64)
    return dict(type="FramesMotionTransferTestDataset_CrossID_videopair_"
                     "anchor", root_dir=str(tree),
                pairs_list=str(tree / "videos.csv"), gt_size=64)


@pytest.mark.parametrize("kind", ["pairs", "videos"])
def test_pair_datasets_equal_jax(tree, kind):
    import pandas as pd

    csv_path = str(tree / f"{kind}.csv")
    records = pd.read_csv(csv_path).to_dict("records")
    assert read_pairs(csv_path) == [{k: str(v) for k, v in r.items()}
                                    for r in records]
    got, want = build_dataset(_ds_opt(tree, kind)), jax_build_dataset(
        _ds_opt(tree, kind))
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.fixture(scope="module")
def jax_nets():
    return converted_tiny_nets(3)


@pytest.fixture(scope="module")
def weights(jax_nets, tmp_path_factory):
    """The JAX tiny variables as converter .npz files, which the port's
    build_and_load reads."""
    d = tmp_path_factory.mktemp("weights")
    _, _, g_vars, m_vars = jax_nets
    save_npz(g_vars, str(d / "net_g.npz"))
    save_npz(m_vars, str(d / "net_m.npz"))
    return d


def _option_file(tmp_path, tree, weights, kind, side):
    with open(osp.join(ROOT, "options", "tiny.yml")) as f:
        opt = yaml.safe_load(f)
    opt["name"] = f"eval-{kind}"
    opt["datasets"] = {"test": dict(_ds_opt(tree, kind), name="set")}
    opt["path"] = {"pretrain_network_g": str(weights / "net_g.npz"),
                   "pretrain_network_motion_estimator":
                       str(weights / "net_m.npz"),
                   "save_path": str(tmp_path / side)}
    opt["val"] = {"relative": True, "adapt_scale": True, "metrics": {
        "psnr": {"type": "calculate_psnr", "crop_border": 0},
        "ssim": {"type": "calculate_ssim", "crop_border": 0},
        "l1": {"type": "calculate_l1", "crop_border": 0}}}
    p = tmp_path / f"{side}.yml"
    p.write_text(yaml.safe_dump(opt))
    return str(p)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(fn, argv):
    """fn(argv) with the 'samt' logger's messages collected."""
    handler = _Lines()
    logger = logging.getLogger("samt")
    logger.addHandler(handler)
    try:
        return fn(argv), handler.lines
    finally:
        logger.removeHandler(handler)


def _files(vis):
    return sorted(osp.relpath(osp.join(d, f), vis)
                  for d, _, fs in os.walk(vis) for f in fs)


def _direct_metrics(vis):
    """PSNR/SSIM/L1 averaged over the written result/driving PNGs."""
    res = sorted(os.listdir(osp.join(vis, "result")))
    sums = np.zeros(3)
    for r in res:
        a = cv2.imread(osp.join(vis, "result", r))
        b = cv2.imread(osp.join(vis, "driving", r[:-6] + "_d.png"))
        sums += [calculate_psnr(a, b, 0), calculate_ssim(a, b, 0),
                 calculate_l1(a, b, 0)]
    return dict(zip(("psnr", "ssim", "l1"), sums / len(res)))


@pytest.mark.parametrize("entry", ["test", "animate"])
def test_entry_point_matches_jax(tree, weights, jax_nets, tmp_path,
                                 monkeypatch, entry):
    """The JAX entry point gets the same variables the .npz files hold,
    without its own initialisation compiles."""
    import synergize_motion_appearance_tpu.demo as jax_demo

    monkeypatch.setattr(jax_demo, "build_and_load", lambda opt: jax_nets)
    kind = "pairs" if entry == "test" else "videos"
    port_main = port_test.main if entry == "test" else animate.main
    jax_main = jax_test.main if entry == "test" else jax_animate.main
    extra = [] if entry == "test" else ["--frame_batch", "4"]
    results, lines = _run(port_main, ["-opt", _option_file(
        tmp_path, tree, weights, kind, "port"), "--device", "cpu"] + extra)
    _run(jax_main, ["-opt", _option_file(tmp_path, tree, weights, kind,
                                         "jax")] + extra)
    sub = osp.join("results", f"eval-{kind}", "visualization", "set")
    port_vis, jax_vis = tmp_path / "port" / sub, tmp_path / "jax" / sub
    files = _files(port_vis)
    assert files == _files(jax_vis)
    n = 2 if entry == "test" else 3 + 4
    assert len([f for f in files if f.startswith("result" + os.sep)]) == n
    if entry == "test":
        for f in files:
            if f.startswith("result" + os.sep):
                a = cv2.imread(str(port_vis / f)).astype(np.int32)
                b = cv2.imread(str(jax_vis / f)).astype(np.int32)
                assert np.abs(a - b).max() <= 1, f
    else:
        assert {f.split(os.sep)[0] for f in files} >= {"result_videos",
                                                       "visual_videos"}
    direct = _direct_metrics(str(port_vis))
    for m, v in direct.items():
        assert results["set"][m] == pytest.approx(v, rel=1e-12, abs=1e-12)
        assert f"  # {m}: {v:.4f}" in lines
    assert results["set"]["l1_255"] == pytest.approx(direct["l1"] / 255.0)
