"""The serving entry points on the CPU: ``export_serving.main`` on
options/tiny.yml, then ``demo.main --from_export`` on a PNG source and a
short video written here with OpenCV, against ``demo.main --config`` on
the same files (modelled on the JAX package's
tests/test_serving_export.py::test_demo_cli_from_export).

Bound: the served frames are within 1 uint8 level of the ``--config``
run's (tests/test_torch_serving.py's contract for an artifact against the
pipeline it was exported from).
"""
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    demo,
    export_serving,
)
from synergize_motion_appearance_tpu_torch.utils.img_util import (  # noqa: E402
    mimsave,
    read_video_frames,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_YML = osp.join(ROOT, "options", "tiny.yml")
N_FRAMES = 7
FLAGS = ["--relative", "--adapt_scale", "--frame_batch", "4"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """An artifact of options/tiny.yml (seeded weights, float32) and the
    demo's inputs: a PNG source and an .mp4 of 7 frames."""
    d = tmp_path_factory.mktemp("serving_cli")
    art = str(d / "art")
    assert export_serving.main(["--config", TINY_YML, "--out", art,
                                "--cpu"] + FLAGS) == art
    rng = np.random.RandomState(70)
    src = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(d / "source.png"), src)
    base = (rng.rand(80, 80, 3) * 255).astype(np.uint8)
    mimsave([base[i:i + 64, i:i + 64] for i in range(N_FRAMES)],
            str(d / "driving.mp4"), fps=5)
    return d, art


@pytest.mark.parametrize("anchor", [[], ["--find_best_frame"]],
                         ids=["plain", "find_best_frame"])
def test_demo_from_export_matches_config_run(exported, tmp_path, anchor):
    d, art = exported
    io = ["--source_image", str(d / "source.png"),
          "--driving_video", str(d / "driving.mp4"), "--cpu"]
    out = tmp_path / "served.mp4"
    served = demo.main(["--from_export", art, "--result_video", str(out)]
                       + io + anchor)
    live = demo.main(["--config", TINY_YML, "--result_video",
                      str(tmp_path / "live.mp4")] + FLAGS + io + anchor)
    assert served.shape == (N_FRAMES, 64, 64, 3)
    diff = np.abs(demo.to_uint8(served).astype(np.int32)
                  - demo.to_uint8(live).astype(np.int32))
    assert diff.max() <= 1
    written, _ = read_video_frames(str(out))
    assert len(written) == N_FRAMES and written[0].shape == (64, 64, 3)


def test_export_refuses_several_platforms(tmp_path):
    """Without a card, --platforms cpu,cuda raises, names the device
    whose programs it cannot trace, and writes nothing."""
    with pytest.raises(RuntimeError, match="cuda programs needs a CUDA"):
        export_serving.main(["--config", TINY_YML, "--out",
                             str(tmp_path / "art"), "--platforms",
                             "cpu,cuda"])
    assert not (tmp_path / "art").exists()


def test_from_export_refuses_another_device(exported):
    """A CPU artifact does not run where the card was asked for."""
    d, art = exported
    with pytest.raises(ValueError, match="exported for cpu"):
        demo.main(["--from_export", art, "--source_image",
                   str(d / "source.png"), "--driving_video",
                   str(d / "driving.mp4"), "--result_video",
                   str(d / "x.mp4")])
