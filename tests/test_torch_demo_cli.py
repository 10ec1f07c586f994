"""The port's inference CLI and what it stands on, on the CPU: trained-weight
loading (a reference-style torch file and the .npz of
tools/convert_reference_checkpoint.py), ``animate_with_anchor`` and the
anchor choice against the JAX package's, ``demo.main`` with each of its
flags against the port's pipeline called directly, the colour and
host-downsample helpers of ``--fast`` against the JAX package's.

One JAX tiny pipeline (options/tiny.yml, float32) is compiled for the
whole file; its weights are the port's seeded ones put through
tools/convert_reference_checkpoint.py. Bounds: in float32 the port's
uint8 frames are within 1 level of the JAX package's
(tests/test_torch_pipeline.py's contract); the anchor index is the same;
the CPU demo is deterministic, so its frames equal the direct pipeline's
exactly; the colour conversions and the host
downsample are the same arithmetic as the JAX package's (rgb_to_yuv420
and blur_stride_u8 exact, yuv420_to_rgb within 1e-5, the numpy
downsample within 1e-6).
"""
import sys
import types
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("imageio")

import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu import inference as jinf  # noqa: E402
from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build,
)
from synergize_motion_appearance_tpu.ops import color as jcolor  # noqa: E402
from synergize_motion_appearance_tpu.ops import coords as jcoords  # noqa: E402
from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    configs,
    demo,
    inference,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    color,
    coords,
)
from synergize_motion_appearance_tpu_torch.training import (  # noqa: E402
    export_params,
    load_variables,
)
from synergize_motion_appearance_tpu_torch.utils.img_util import (  # noqa: E402
    read_video_frames,
)
from synergize_motion_appearance_tpu_torch.utils.options import (  # noqa: E402
    load_yaml,
)
from synergize_motion_appearance_tpu_torch.weights import (  # noqa: E402
    seeded_nets,
)
from test_torch_models import frames, port_nets  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))
from convert_reference_checkpoint import (  # noqa: E402
    convert_motion_estimator,
    convert_net_g,
)
from convert_vgg_weights import save_npz  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_YML = osp.join(ROOT, "options", "tiny.yml")
N_FRAMES, FRAME_BATCH, ANCHOR = 7, 4, 3
KW = dict(relative=True, adapt_scale=True, frame_batch=FRAME_BATCH,
          u8_io=True)


def converted_tiny_nets(seed):
    """(net_g, motion_estimator, g_vars, m_vars): the JAX tiny nets and
    the port's seeded weights put through
    tools/convert_reference_checkpoint.py, as a released reference
    checkpoint is (no JAX initialisation to compile)."""
    cfg = configs.get("tiny")
    g, me = seeded_nets(cfg, seed)
    g_vars, unused_g = convert_net_g(
        {k: v.numpy() for k, v in g.state_dict().items()}, cfg["network_g"])
    m_vars, unused_m = convert_motion_estimator(
        {k: v.numpy() for k, v in me.state_dict().items()},
        num_blocks_kp=2, num_blocks_dm=2)
    assert not unused_g and not unused_m
    return (jax_build(dict(cfg["network_g"])),
            jax_build(dict(cfg["network_motion_estimator"])), g_vars, m_vars)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX tiny nets, their f32 pipeline, a source and driving frames
    whose frame ANCHOR is the source itself (so one frame is clearly
    nearest: its keypoints equal the source's)."""
    cfg = configs.get("tiny")
    jg, jme, g_vars, m_vars = converted_tiny_nets(1)
    jpipe = jinf.ReenactmentPipeline(jg, jme, g_vars, m_vars,
                                     compute_dtype=None, **KW)
    src = frames(1, 30)
    drv = frames(N_FRAMES, 31)
    drv[ANCHOR] = src[0]
    return cfg, g_vars, m_vars, jpipe, src, drv


def _port_pipeline(g, me):
    return inference.ReenactmentPipeline(g, me, compute_dtype=torch.float32,
                                         device="cpu", **KW)


def _levels(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32)).max()


def _config(g_path, m_path, **keys):
    cfg = configs.get("tiny")
    cfg["path"] = dict(pretrain_network_g=g_path,
                       pretrain_network_motion_estimator=m_path, **keys)
    return cfg


# ---------------------------------------------------------------------------
# trained-weight loading
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["param_key", "params_fallback", "bare"])
def test_build_and_load_torch_file(jax_setup, tmp_path, layout):
    """A reference-style torch file ({param_key: state_dict}, the
    params_ema -> params fallback, or a bare state_dict) loads
    strict=True into both networks."""
    cfg, g_vars, m_vars = jax_setup[:3]
    g, me = port_nets(cfg, g_vars, m_vars)
    g_path, m_path = str(tmp_path / "net_g.pth"), str(tmp_path / "net_m.pth")
    if layout == "param_key":
        export_params(g_path, g.state_dict(), "params_ema")
        export_params(m_path, me.state_dict(), "params")
    elif layout == "params_fallback":
        export_params(g_path, g.state_dict(), "params")
        export_params(m_path, me.state_dict(), "params")
    else:
        torch.save(g.state_dict(), g_path)
        torch.save(me.state_dict(), m_path)
    lg, lme = demo.build_and_load(_config(g_path, m_path), "cpu")
    for want, got in ((g, lg), (me, lme)):
        sd = got.state_dict()
        assert sorted(sd) == sorted(want.state_dict())
        for k, v in want.state_dict().items():
            assert torch.equal(sd[k], v), k


def test_build_and_load_converter_npz_matches_jax(jax_setup, tmp_path):
    """The .npz that tools/convert_reference_checkpoint.py writes (flat
    flax keys under params/ and batch_stats/) loads strict=True; the
    pipeline's frames are within 1 level of the JAX pipeline's on those
    weights."""
    cfg, g_vars, m_vars, jpipe, src, drv = jax_setup
    g_path, m_path = str(tmp_path / "net_g.npz"), str(tmp_path / "net_m.npz")
    save_npz(g_vars, g_path)
    save_npz(m_vars, m_path)
    g, me = demo.build_and_load(
        _config(g_path, m_path, param_key_g="params_ema"), "cpu")
    got = _port_pipeline(g, me).animate(src, drv)
    want = np.asarray(jpipe.animate(src, drv))
    assert got.shape == (N_FRAMES, 64, 64, 3)
    assert _levels(got, want) <= 1


def test_load_variables_refuses_orbax_directory(tmp_path):
    with pytest.raises(RuntimeError, match="convert_reference_checkpoint"):
        load_variables(str(tmp_path), "params")


# ---------------------------------------------------------------------------
# the anchor
# ---------------------------------------------------------------------------

def test_anchor_path_matches_jax(jax_setup):
    """find_best_frame_kp picks the same frame as the JAX package's, and
    animate_with_anchor's frames are within 1 level of its."""
    cfg, g_vars, m_vars, jpipe, src, drv = jax_setup
    pipe = _port_pipeline(*port_nets(cfg, g_vars, m_vars))
    anchor = inference.find_best_frame_kp(pipe, src, drv)
    assert anchor == jinf.find_best_frame_kp(jpipe, src, drv) == ANCHOR
    got = pipe.animate_with_anchor(src, drv, anchor)
    want = np.asarray(jpipe.animate_with_anchor(src, drv, anchor))
    assert got.shape == (N_FRAMES, 64, 64, 3)
    assert _levels(got, want) <= 1
    # the anchor's frame is the forward half's first frame
    np.testing.assert_array_equal(got[anchor],
                                  pipe.animate(src, drv[anchor:])[0])


def _fake_face_alignment():
    """Landmarks as a smooth function of the image (68 points)."""
    def landmarks(img):
        img = np.asarray(img, np.float64)
        base = np.random.RandomState(1234).rand(68, 2) * 200.0 + 28.0
        return [base + img.reshape(-1)[:136].reshape(68, 2) / 255.0 * 40.0]

    mod = types.ModuleType("face_alignment")
    mod.LandmarksType = types.SimpleNamespace(TWO_D="2d")

    class FaceAlignment:
        def __init__(self, *a, **k):
            pass

        get_landmarks = staticmethod(landmarks)

    mod.FaceAlignment = FaceAlignment
    return mod


def test_find_best_frame_fa_matches_jax(monkeypatch):
    """face_alignment's criterion on the same (fake) landmarks."""
    monkeypatch.setitem(sys.modules, "face_alignment",
                        _fake_face_alignment())
    rng = np.random.RandomState(5)
    src = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    drv = rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)
    drv[6] = src[0] + 0.01
    got = inference.find_best_frame(src, drv, cpu=True)
    assert got == jinf.find_best_frame(src, drv, cpu=True) == 6


# ---------------------------------------------------------------------------
# demo.main
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    """A PNG source and a folder of PNG driving frames, 64x64, with frame
    2 a copy of the source."""
    d = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(40)
    src = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(d / "source.png"), src)
    (d / "driving").mkdir()
    base = (rng.rand(80, 80, 3) * 255).astype(np.uint8)
    for i in range(6):
        cv2.imwrite(str(d / "driving" / f"{i:04d}.png"),
                    src if i == 2 else base[i:i + 64, i:i + 64])
    return d


@pytest.mark.parametrize("flags", [
    [], ["--find_best_frame"], ["--best_frame", "4"], ["--fast"],
    ["--bf16", "--visual_video"]], ids=lambda f: " ".join(f) or "plain")
def test_demo_main_matches_pipeline(demo_inputs, tmp_path, flags):
    d = demo_inputs
    out = tmp_path / "result.gif"
    argv = ["--config", TINY_YML, "--cpu", "--relative", "--adapt_scale",
            "--frame_batch", "4", "--source_image", str(d / "source.png"),
            "--driving_video", str(d / "driving"),
            "--result_video", str(out)]
    if "--visual_video" in flags:
        flags = [f for f in flags if f != "--visual_video"] + [
            "--visual_video", str(tmp_path / "visual.gif")]
    preds = demo.main(argv + flags)

    fast = "--fast" in flags
    config = load_yaml(TINY_YML)
    source, driving, frames_rgb, _ = demo.decode_inputs(
        str(d / "source.png"), str(d / "driving"), 64)
    if fast:
        source, driving = demo.to_uint8(source), demo.to_uint8(driving)
    g, me = demo.build_and_load(config, "cpu")
    pipe = inference.ReenactmentPipeline(
        g, me, relative=True, adapt_scale=True, frame_batch=4,
        compute_dtype=(torch.bfloat16 if fast or "--bf16" in flags
                       else torch.float32),
        u8_io=fast, yuv420_io=fast, host_kp_downsample=fast, device="cpu")
    anchor = None
    if "--find_best_frame" in flags:
        anchor = inference.find_best_frame_kp(pipe, source, driving)
        assert anchor == 2
    elif "--best_frame" in flags:
        anchor = 4
    want = demo.reenact(pipe, source, driving, anchor)
    np.testing.assert_array_equal(preds, want)
    assert preds.dtype == (np.uint8 if fast else np.float32)
    written, _ = read_video_frames(str(out))
    assert len(written) == 6 and written[0].shape == (64, 64, 3)
    if "--visual_video" in argv + flags:
        visual, _ = read_video_frames(str(tmp_path / "visual.gif"))
        assert len(visual) == 6 and visual[0].shape == (64, 192, 3)


def test_demo_from_export_is_not_ported():
    """``--from_export`` is ported (tests/test_torch_serving_cli.py); a
    directory that holds no artifact raises before anything is decoded."""
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        demo.main(["--from_export", "somewhere"])


# ---------------------------------------------------------------------------
# --fast: colour conversion and the host downsample
# ---------------------------------------------------------------------------

def test_rgb_to_yuv420_matches_jax():
    rng = np.random.RandomState(50)
    model = rng.uniform(-1.1, 1.1, (2, 16, 12, 3)).astype(np.float32)
    u8 = (rng.rand(2, 16, 12, 3) * 255).astype(np.uint8)
    for x in (model, u8):
        got = color.rgb_to_yuv420(torch.from_numpy(x)).numpy()
        want = np.asarray(jcolor.rgb_to_yuv420(jnp.asarray(x)))
        assert got.dtype == np.uint8 and got.shape == (2, 24, 12)
        np.testing.assert_array_equal(got, want)
    packed = color.rgb_to_yuv420(torch.from_numpy(u8))
    for model_domain in (True, False):
        got = color.yuv420_to_rgb(packed, model_domain).numpy()
        want = np.asarray(jcolor.yuv420_to_rgb(jnp.asarray(packed.numpy()),
                                               model_domain))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_host_downsample_matches_jax():
    rng = np.random.RandomState(51)
    f = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    u8 = (rng.rand(3, 64, 64, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(coords.antialias_downsample_host(f, 0.25),
                               jcoords.antialias_downsample_host(f, 0.25),
                               rtol=0, atol=1e-6)
    got = coords.blur_stride_u8(u8, 0.25)
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(got, jcoords.blur_stride_u8(u8, 0.25))
    # the host downsample is the device one's arithmetic
    dev = coords.antialias_downsample(
        torch.from_numpy(f).permute(0, 3, 1, 2), 0.25).permute(0, 2, 3, 1)
    np.testing.assert_allclose(coords.antialias_downsample_host(f, 0.25),
                               dev.numpy(), rtol=0, atol=1e-5)


def test_imfrombytes_matches_jax():
    from synergize_motion_appearance_tpu.utils import img_util as jimg
    from synergize_motion_appearance_tpu_torch.utils import img_util

    img = (np.random.RandomState(52).rand(9, 7, 3) * 255).astype(np.uint8)
    data = cv2.imencode(".png", img)[1].tobytes()
    for float32 in (False, True):
        got = img_util.imfrombytes(data, float32)
        np.testing.assert_array_equal(got, jimg.imfrombytes(data, float32))
    np.testing.assert_array_equal(img_util.imfrombytes(data), img)


def test_blur_stride_u8_names_cv2_when_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        coords.blur_stride_u8(np.zeros((1, 8, 8, 3), np.uint8), 0.25)


def test_host_kp_downsample_keypoints(jax_setup):
    """Keypoints from frames downsampled on the host (float frames: numpy;
    uint8: OpenCV) against the detector's own downsample: the host path
    rounds its input to bfloat16, which moves keypoints by < 1e-2."""
    cfg, g_vars, m_vars, _, src, drv = jax_setup
    g, me = port_nets(cfg, g_vars, m_vars)
    pipe = _port_pipeline(g, me)
    host = inference.ReenactmentPipeline(
        g, me, compute_dtype=torch.float32, device="cpu",
        host_kp_downsample=True)
    for x in (drv, drv.astype(np.float32) / 127.5 - 1.0):
        with torch.no_grad():
            got = host._kp_frames(x)["value"]
        want = pipe.estimate_kp(x)["value"]
        assert (got - want).abs().max() < 1e-2
