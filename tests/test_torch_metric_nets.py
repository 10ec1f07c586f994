"""The port's metric networks and metrics against the JAX package's, on
the CPU: FID's InceptionV3, LPIPS-VGG16 and OpenFace, each built with
seeded random weights in the port and carried to the JAX module by the
JAX package's own converters (``convert_torch_inception``,
``convert_lpips_weights``, ``convert_openface_weights``), which read the
port's module names; then ``calculate_fid``, ``calculate_lpips`` and
``calculate_aed`` on small image directories with those weights written
to files, the missing-weights error, ``frechet_distance``, ``pose_util``
and ``LPIPSLoss``.

Tolerances: both sides run float32 (JAX at 'highest' matmul precision,
tests/conftest.py) and sum convolutions in different orders, ~1e-6
relative per layer; through InceptionV3's ~95 convolutions the outputs
stay within 1e-4 of the largest output (the bound held here), the metric
values within 1e-4 relative. ``frechet_distance`` is the same float64
scipy arithmetic on both sides (1e-6), ``pose_util`` the same numpy code
(exact).
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.losses.losses import (  # noqa: E402
    LPIPSLoss as JaxLPIPSLoss,
)
from synergize_motion_appearance_tpu.metrics import (  # noqa: E402
    external as jext,
    inception as jinc,
    lpips_jax as jlp,
    openface as jof,
    pose_util as jpose,
)
from synergize_motion_appearance_tpu_torch.losses import (  # noqa: E402
    LPIPSLoss,
)
from synergize_motion_appearance_tpu_torch.metrics import (  # noqa: E402
    calculate_metric,
    external,
    inception,
    lpips,
    openface,
    pose_util,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

REL = 1e-4


def _randomize(net, seed):
    """He-normal convolutions and linears (activations stay O(1) through
    the deep nets), non-trivial BatchNorm affines and statistics, positive
    LPIPS heads."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if name.startswith("lin"):
                    m.weight.abs_()
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=gen))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))
    return net.eval()


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    inc = _randomize(inception.FIDInceptionV3(), 0)
    lp = _randomize(lpips.LPIPSVgg(), 1)
    of = _randomize(openface.OpenFaceNet(), 2)
    sd = {"inception": inc.state_dict(), "lpips": lp.state_dict(),
          "openface": of.state_dict()}
    jparams = {
        "inception": jinc.convert_torch_inception(sd["inception"]),
        "lpips": jlp.convert_lpips_weights(sd["lpips"], sd["lpips"]),
        "openface": jof.convert_openface_weights(sd["openface"]),
    }
    return {"inception": inc, "lpips": lp, "openface": of}, sd, jparams


def _images(n, c, h, w, seed, lo=0.0, hi=1.0):
    x = np.random.RandomState(seed).uniform(lo, hi, (n, h, w, c))
    return x.astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_inception_matches_jax(nets):
    net, jparams = nets[0]["inception"], nets[2]["inception"]
    x = _images(2, 3, 75, 75, 10, -1.0, 1.0)  # Inception's smallest input
    with torch.no_grad():
        got = net(_nchw(x)).flatten(1).numpy()
    want = jax.jit(lambda p, v: jinc.FIDInceptionV3().apply(
        {"params": p}, v)[-1])(_to_jax(jparams), x)
    assert _rel_err(got, np.asarray(want).reshape(2, -1)) <= REL


def test_inception_preprocess_matches_jax():
    """256 -> 299 bilinear, align_corners=False, then [-1, 1]."""
    x = _images(2, 3, 256, 256, 11)
    got = inception.preprocess(_nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jinc.preprocess(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_lpips_matches_jax(nets):
    net, jparams = nets[0]["lpips"], nets[2]["lpips"]
    x = _images(2, 3, 64, 64, 12, -1.0, 1.0)
    y = _images(2, 3, 64, 64, 13, -1.0, 1.0)
    with torch.no_grad():
        got = lpips.lpips_distance(net, _nchw(x), _nchw(y)).numpy()
    want = jax.jit(jlp.lpips_distance)(_to_jax(jparams), x, y)
    assert _rel_err(got, want) <= REL


def test_openface_matches_jax(nets):
    net, jparams = nets[0]["openface"], nets[2]["openface"]
    x = _images(2, 3, 96, 96, 14)
    with torch.no_grad():
        emb, feat = net(_nchw(x))
    jemb, jfeat = jax.jit(lambda p, v: jof.OpenFaceNet().apply(
        {"params": p}, v))(_to_jax(jparams), x)
    assert _rel_err(feat.numpy(), jfeat) <= REL
    assert _rel_err(emb.numpy(), jemb) <= REL


@pytest.mark.parametrize("name,to_port", [
    ("inception", inception.inception_state_dict),
    ("lpips", lpips.lpips_state_dict),
    ("openface", openface.openface_state_dict),
])
def test_npz_key_maps_invert_the_jax_converters(nets, name, to_port):
    """The JAX package's converted .npz (flatten_params of its converter's
    tree) loads into the port's module strictly, to the same weights."""
    _, sd, jparams = nets
    got = to_port(jext.flatten_params(jparams[name]))
    net = {"inception": inception.FIDInceptionV3, "lpips": lpips.LPIPSVgg,
           "openface": openface.OpenFaceNet}[name]()
    net.load_state_dict(got, strict=True)
    for k, v in got.items():
        assert torch.equal(v, sd[name][k].float()), k


@pytest.fixture(scope="module")
def weight_files(nets, tmp_path_factory):
    """Inception and OpenFace as torch files of the port's state_dicts
    (pytorch-fid's and openface.pth's names), LPIPS as the JAX package's
    .npz; each side loads each file its own way."""
    _, sd, jparams = nets
    d = tmp_path_factory.mktemp("weights")
    # pytorch-fid's file also holds the 1008-way classifier, which FID
    # never uses: both sides drop it
    gen = torch.Generator().manual_seed(3)
    torch.save(dict(sd["inception"],
                    **{"fc.weight": torch.randn(1008, 2048, generator=gen),
                       "fc.bias": torch.zeros(1008)}),
               d / "pt_inception-2015-12-05-6726825d.pth")
    torch.save(sd["openface"], d / "openface.pth")
    np.savez(d / "lpips_vgg.npz", **jext.flatten_params(jparams["lpips"]))
    return d


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """result/driving/source PNG directories of three 32x32 frames each,
    named as test.py writes them."""
    root = tmp_path_factory.mktemp("vis")
    rng = np.random.RandomState(20)
    for sub, suffix in (("result", "r"), ("driving", "d"), ("source", "s")):
        (root / sub).mkdir()
        for i in range(3):
            img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / sub / f"f{i}_{suffix}.png"), img)
    return root


@pytest.fixture
def weights_env(weight_files, monkeypatch):
    for var in ("SAMT_INCEPTION_WEIGHTS", "SAMT_LPIPS_WEIGHTS",
                "SAMT_OPENFACE_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SAMT_WEIGHTS_DIR", str(weight_files))


@pytest.mark.parametrize("metric", ["fid", "lpips", "aed"])
def test_directory_metrics_match_jax(weights_env, image_dirs, metric):
    r, d, s = (str(image_dirs / k) for k in ("result", "driving", "source"))
    if metric == "fid":
        data, opt = dict(paths=[s, r]), dict(batch_size=3)
    elif metric == "lpips":
        data, opt = dict(path1=r, path2=d), dict(batch_size=3)
    else:
        data, opt = dict(path_gt=d, path_generated=r), {}
    opt["type"] = f"calculate_{metric}"
    got = calculate_metric(dict(data, device="cpu"), opt)
    want = getattr(jext, f"calculate_{metric}")(**data, **{
        k: v for k, v in opt.items() if k != "type"})
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= REL * abs(want), (got, want)


@pytest.mark.parametrize("metric,env,name", [
    ("fid", "SAMT_INCEPTION_WEIGHTS",
     "pt_inception-2015-12-05-6726825d.pth"),
    ("lpips", "SAMT_LPIPS_WEIGHTS", "lpips_vgg.npz"),
    ("aed", "SAMT_OPENFACE_WEIGHTS", "openface.pth"),
])
def test_missing_weights_name_the_file(image_dirs, tmp_path, monkeypatch,
                                       metric, env, name):
    monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("SAMT_WEIGHTS_DIR", str(tmp_path))
    d = str(image_dirs / "driving")
    data = {"fid": dict(paths=[d, d]), "lpips": dict(path1=d, path2=d),
            "aed": dict(path_gt=d, path_generated=d)}[metric]
    with pytest.raises(RuntimeError, match=name):
        calculate_metric(dict(data, device="cpu"),
                         {"type": f"calculate_{metric}"})


@pytest.mark.parametrize("metric,package", [
    ("akd", "face_alignment"), ("id_similarity", "insightface"),
    ("pose_accuracy", "mediapipe")])
def test_face_model_metrics_name_their_package(image_dirs, metric, package):
    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed")
    d = str(image_dirs / "driving")
    with pytest.raises(RuntimeError, match=package):
        calculate_metric(dict(path_gt=d, path_generated=d),
                         {"type": f"calculate_{metric}"})


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(30)
    f1, f2 = rng.randn(40, 16), rng.randn(40, 16) + 0.3
    s1, s2 = (external.activation_statistics(f) for f in (f1, f2))
    got = external.frechet_distance(*s1, *s2)
    want = jext.frechet_distance(*jext.activation_statistics(f1),
                                 *jext.activation_statistics(f2))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_pose_util_matches_jax():
    rng = np.random.RandomState(31)
    poses = np.concatenate([rng.uniform(-40, 40, (4, 3)),
                            rng.uniform(-5, 5, (4, 3))], axis=1)
    pts = rng.randn(4, 6, 3)
    tm = jpose.euler_and_translation_to_matrix([5.0, -10.0, 3.0],
                                               [0.1, 0.2, -30.0])
    np.testing.assert_array_equal(pose_util.create_perspective_matrix(1.25),
                                  jpose.create_perspective_matrix(1.25))
    for p in poses:
        m = pose_util.euler_and_translation_to_matrix(p[:3], p[3:])
        np.testing.assert_array_equal(
            m, jpose.euler_and_translation_to_matrix(p[:3], p[3:]))
        for a, b in zip(pose_util.matrix_to_euler_and_translation(m),
                        jpose.matrix_to_euler_and_translation(m)):
            np.testing.assert_array_equal(a, b)
    proj = pose_util.project_points(pts, tm, poses, (64, 80))
    np.testing.assert_array_equal(
        proj, jpose.project_points(pts, tm, poses, (64, 80)))
    np.testing.assert_array_equal(
        pose_util.invert_projection(proj, tm, poses, (64, 80)),
        jpose.invert_projection(proj, tm, poses, (64, 80)))
    np.testing.assert_array_equal(
        pose_util.project_points_with_trans(pts[0], tm, (64, 80)),
        jpose.project_points_with_trans(pts[0], tm, (64, 80)))
    np.testing.assert_array_equal(pose_util.smooth_pose_seq(poses, 3),
                                  jpose.smooth_pose_seq(poses, 3))


def test_lpips_loss_matches_jax(weights_env):
    x = _images(2, 3, 32, 32, 40, -1.0, 1.0)
    gt = _images(2, 3, 32, 32, 41, -1.0, 1.0)
    kw = dict(loss_weight=0.5, range_norm=True)
    got = float(LPIPSLoss(**kw)(_nchw(x), _nchw(gt)))
    want = float(JaxLPIPSLoss(**kw)(jnp.asarray(x), jnp.asarray(gt)))
    assert abs(got - want) <= REL * abs(want), (got, want)
