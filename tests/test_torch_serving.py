"""The port's serving artifacts on the CPU (options/tiny.yml): the stages
exported by ``serving.export_pipeline`` and run by ``ServingPipeline``
against the live pipeline they were exported from, and against the JAX
package's live pipeline on the same weights, as the JAX package's
tests/test_serving_export.py holds its own artifacts.

Bounds: the served programs run the live stages' operators on the same
inputs, so float32 frames agree within 1e-5 and uint8 frames within 1
level (both are equal here; the bounds leave room for another operator
order after export). Against the JAX package's float32 pipeline the
frames are within 1 uint8 level, the port's contract with the JAX
package (tests/test_torch_pipeline.py). One JAX tiny pipeline is
compiled for the file; its weights are the port's seeded ones put
through tools/convert_reference_checkpoint.py.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu import inference as jinf  # noqa: E402
from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    configs,
    demo,
    inference,
    serving,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention,
)
from synergize_motion_appearance_tpu_torch.weights import (  # noqa: E402
    seeded_nets,
)
from test_torch_demo_cli import converted_tiny_nets  # noqa: E402
from test_torch_models import frames  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

N_FRAMES, FRAME_BATCH, ANCHOR, SEED = 7, 4, 3, 1
KW = dict(relative=True, adapt_scale=True, frame_batch=FRAME_BATCH)
FAST = dict(compute_dtype=torch.bfloat16, u8_io=True, yuv420_io=True,
            host_kp_downsample=True)


def _live(seed=SEED, **kw):
    g, me = seeded_nets(configs.get("tiny"), seed)
    return inference.ReenactmentPipeline(g, me, device="cpu",
                                         **{**KW, **kw})


def _inputs():
    src = frames(1, 60)
    drv = frames(N_FRAMES, 61)
    return src, drv, src.astype(np.float32) / 127.5 - 1.0, \
        drv.astype(np.float32) / 127.5 - 1.0


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """A float32 artifact (float32 frames out) of the seeded live
    pipeline, loaded back."""
    live = _live(compute_dtype=torch.float32)
    art = str(tmp_path_factory.mktemp("serving") / "f32")
    serving.export_pipeline(live, art)
    return live, art, serving.load_serving_pipeline(art, "cpu")


def _levels(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_artifact_files_and_manifest(f32):
    live, art, _ = f32
    names = sorted(os.listdir(art))
    assert names == sorted(["manifest.json", "params.pt"] + [
        f"{s}.pt2" for s in serving._STAGES])
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == serving.FORMAT_VERSION
    assert manifest["platforms"] == ["cpu"]
    assert manifest["compute_dtype"] == "float32"
    assert (manifest["img_size"], manifest["frame_batch"]) == (
        64, FRAME_BATCH)
    assert manifest["relative"] and manifest["adapt_scale"]
    want = {**{f"g/{k}": v for k, v in live.g_weights.items()},
            **{f"m/{k}": v for k, v in live.m_weights.items()}}
    assert list(manifest["param_dtypes"]) == list(want)
    params = torch.load(os.path.join(art, "params.pt"), weights_only=True)
    assert list(params) == list(want)
    for k, v in want.items():
        assert torch.equal(params[k], v), k


def test_programs_hold_no_weights_and_gen_calls_k1(f32):
    """No program carries a parameter or a buffer (the weights are its
    arguments); the generation program calls the samt K1 operator and no
    other attention."""
    _, art, _ = f32
    for stage in serving._STAGES:
        ep = torch.export.load(os.path.join(art, f"{stage}.pt2"))
        assert ep.state_dict == {}, stage
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        k1 = targets.count("samt.fused_attention_packed.default")
        assert k1 == (16 if stage == "gen" else 0), (stage, k1)
        assert not any("scaled_dot_product" in t for t in targets)


def test_served_f32_matches_live(f32):
    live, _, served = f32
    _, _, src, drv = _inputs()
    want = live.animate(src, drv)
    got = served.animate(src, drv)
    assert got.dtype == np.float32 and got.shape == (N_FRAMES, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_served_matches_jax_pipeline(f32):
    """The JAX package's live float32 pipeline on the same weights."""
    _, _, served = f32
    jg, jme, g_vars, m_vars = converted_tiny_nets(SEED)
    jpipe = jinf.ReenactmentPipeline(jg, jme, g_vars, m_vars,
                                     compute_dtype=None, **KW)
    _, _, src, drv = _inputs()
    want = np.asarray(jpipe.animate(src, drv))
    got = served.animate(src, drv)
    assert _levels(demo.to_uint8(got), demo.to_uint8(want)) <= 1


def test_served_anchor_matches_live(f32):
    live, _, served = f32
    _, _, src, drv = _inputs()
    got = served.animate_with_anchor(src, drv, ANCHOR)
    want = live.animate_with_anchor(src, drv, ANCHOR)
    assert got.shape == (N_FRAMES, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (inference.find_best_frame_kp(served, src, drv)
            == inference.find_best_frame_kp(live, src, drv))


def test_weight_swap_without_reexport(f32):
    """A second seed's weights in the same programs: the frames change and
    match a live pipeline on those weights; no stage file is touched."""
    live, art, served = f32
    stat = {f: (os.stat(os.path.join(art, f)).st_size,
                os.stat(os.path.join(art, f)).st_mtime_ns)
            for f in os.listdir(art)}
    _, _, src, drv = _inputs()
    old = served.animate(src, drv)
    live2 = _live(seed=SEED + 6, compute_dtype=torch.float32)
    try:
        served.load_weights(live2.g_weights, live2.m_weights)
        new = served.animate(src, drv)
        reshaped = dict(live2.m_weights)
        key = next(iter(reshaped))
        reshaped[key] = reshaped[key][:1]
        with pytest.raises(ValueError, match="shape"):
            served.load_weights(live2.g_weights, reshaped)
        with pytest.raises(ValueError, match="missing"):
            served.load_weights({}, live2.m_weights)
    finally:  # the module's artifact serves the first seed again
        served.load_weights(live.g_weights, live.m_weights)
    assert np.abs(new - old).max() > 1e-3
    np.testing.assert_allclose(new, live2.animate(src, drv), rtol=0,
                               atol=1e-5)
    assert stat == {f: (os.stat(os.path.join(art, f)).st_size,
                        os.stat(os.path.join(art, f)).st_mtime_ns)
                    for f in os.listdir(art)}
    np.testing.assert_array_equal(served.animate(src, drv), old)


def test_wrong_format_version_and_batch_raise(f32, tmp_path):
    _, art, served = f32
    with pytest.raises(ValueError, match="batch 1 or 4"):
        served.estimate_kp(frames(3, 62))
    bad = tmp_path / "bad"
    shutil.copytree(art, bad)
    with open(bad / "manifest.json") as f:
        manifest = json.load(f)
    manifest["format_version"] = serving.FORMAT_VERSION + 1
    with open(bad / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="format"):
        serving.load_serving_pipeline(str(bad))
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.load_serving_pipeline(art, "cuda")


def test_fast_io_round_trip(tmp_path):
    """--fast (bfloat16, uint8 frames both ways, I420 fetch, the host
    keypoint downsample) exported and served, against the live fast
    pipeline."""
    pytest.importorskip("cv2")
    live = _live(**FAST)
    art = str(tmp_path / "fast")
    serving.export_pipeline(live, art)
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["u8_io"] and manifest["yuv420_io"]
    assert manifest["host_kp_downsample"]
    assert manifest["compute_dtype"] == "bfloat16"
    assert manifest["input_dtype"] == "uint8"
    # floating weights in bfloat16; BatchNorm's batch counters stay int64
    assert set(manifest["param_dtypes"].values()) == {"bfloat16", "int64"}
    served = serving.load_serving_pipeline(art, "cpu")
    src, drv, _, _ = _inputs()
    want = live.animate(src, drv)
    got = served.animate(src, drv)
    assert got.dtype == np.uint8 and got.shape == (N_FRAMES, 64, 64, 3)
    assert _levels(got, want) <= 1


@pytest.mark.parametrize("case", ["packed_bias", "packed_codebook",
                                  "split_shared_bias"])
def test_opcheck_attention_ops(case):
    """torch.library.opcheck on the samt attention operators with CPU
    inputs: schema, fake implementation, autograd registration and
    tracing with dynamic shapes."""
    rng = np.random.RandomState(63)
    B, L, K, E, H = 2, 8, 6, 16, 4

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                ).requires_grad_()

    bias = torch.from_numpy(np.where(rng.rand(B, K) < 0.3, -1e30, 0.0)
                            .astype(np.float32))
    if case == "packed_bias":
        op, args = (torch.ops.samt.fused_attention_packed.default,
                    (t(B, L, E), t(B, K, E), t(B, K, E), bias, H))
    elif case == "packed_codebook":
        op, args = (torch.ops.samt.fused_attention_packed.default,
                    (t(B, L, E), t(K, E), t(K, E), None, H))
    else:
        op, args = (torch.ops.samt.fused_attention.default,
                    (t(B, H, L, 4), t(1, H, K, 4), t(1, H, K, 4), bias))
    before = (fused_attention.launches, fused_attention.split_launches)
    torch.library.opcheck(op, args)
    assert (fused_attention.launches,
            fused_attention.split_launches) == before
