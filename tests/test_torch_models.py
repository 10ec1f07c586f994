"""The port's networks against the JAX package's at the tiny config
(options/tiny.yml): the same JAX-initialised weights, carried across by
the port's weights.py, on the same numpy inputs.

Tolerances: everything runs in float32 on both sides (JAX at 'highest'
matmul precision, tests/conftest.py). The two frameworks sum convolutions
and matmuls in different orders, which leaves ~1e-6 relative noise per
layer; through the 20-60 layers of these nets that stays below the stated
bounds (1e-4 for keypoints and single blocks, 1e-5 for the transformer
layer, 2e-4 for the generator's [-1, 1]-scale output), far below what a
wrong index, layout or activation gives.
"""
import sys
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))

from convert_reference_checkpoint import (  # noqa: E402
    export_motion_estimator,
    export_net_g,
)

from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build,
)
from synergize_motion_appearance_tpu.models.transformer import (  # noqa: E402
    TransformerLayer as JaxTransformerLayer,
)
from synergize_motion_appearance_tpu.models import vqgan as jvq  # noqa: E402
from synergize_motion_appearance_tpu_torch import configs, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    build_network,
)
from synergize_motion_appearance_tpu_torch.models import vqgan as tvq  # noqa: E402
from synergize_motion_appearance_tpu_torch.models.transformer import (  # noqa: E402
    TransformerLayer,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

IMG = 64


def _perturb(variables, seed):
    """Add seeded noise to every parameter, so zero- and one-initialised
    ones (norm affines, position embeddings, the Jacobian conv, biases)
    carry information, and give BatchNorm non-trivial running stats."""
    rng = np.random.RandomState(seed)

    def noisy(a):
        a = np.asarray(a, np.float32)
        return a + 0.01 * rng.randn(*a.shape).astype(np.float32)

    out = {"params": jax.tree_util.tree_map(noisy, variables["params"])}
    if "batch_stats" in variables:
        def stat(path, a):
            a = np.asarray(a, np.float32)
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)

        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"])
    return out


def frames(n, seed):
    return (np.random.RandomState(seed).rand(n, IMG, IMG, 3) * 255
            ).astype(np.uint8)


def tiny_jax_nets(cfg):
    """JAX nets of ``cfg`` from build_network + init with fixed keys (the
    generator in train mode, so the training-only heads have parameters
    too), perturbed by _perturb. Returns (net_g, me, g_vars, m_vars) with
    numpy leaves."""
    net_g = jax_build(dict(cfg["network_g"]))
    me = jax_build(dict(cfg["network_motion_estimator"]))
    s = jnp.asarray(frames(1, 0), jnp.float32) / 127.5 - 1.0
    d = jnp.asarray(frames(1, 1), jnp.float32) / 127.5 - 1.0
    m_vars = jax.jit(me.init)(jax.random.PRNGKey(0), d, s)
    dm = jax.jit(me.apply)(m_vars, d, s)
    g_vars = jax.jit(lambda k: net_g.init(k, s, dm, gt=d))(
        jax.random.PRNGKey(1))
    return net_g, me, _perturb(g_vars, 2), _perturb(m_vars, 3)


def port_nets(cfg, g_vars, m_vars):
    g = build_network(cfg["network_g"])
    me = build_network(cfg["network_motion_estimator"])
    g.load_state_dict(weights.net_g_state_dict(g_vars, cfg["network_g"]),
                      strict=True)
    me.load_state_dict(weights.motion_estimator_state_dict(
        m_vars, cfg["network_motion_estimator"]), strict=True)
    return g.eval(), me.eval()


@pytest.fixture(scope="module")
def nets():
    cfg = configs.get("tiny")
    jg, jme, g_vars, m_vars = tiny_jax_nets(cfg)
    tg, tme = port_nets(cfg, g_vars, m_vars)
    return cfg, jg, jme, g_vars, m_vars, tg, tme


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _images(n, seed):
    return frames(n, seed).astype(np.float32) / 127.5 - 1.0


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def test_weights_match_tools_export(nets):
    """weights.py gives the state_dict that the repo's converter exports,
    name for name and value for value."""
    cfg, _, _, g_vars, m_vars, _, _ = nets
    me_cfg = cfg["network_motion_estimator"]
    for ours, theirs in (
        (weights.net_g_state_dict(g_vars, cfg["network_g"]),
         export_net_g(g_vars, dict(cfg["network_g"]))),
        (weights.motion_estimator_state_dict(m_vars, me_cfg),
         export_motion_estimator(
             m_vars, num_blocks_kp=me_cfg["kp_detector_params"]["num_blocks"],
             num_blocks_dm=me_cfg["dense_motion_params"]["num_blocks"],
             scale_factor=me_cfg["dense_motion_params"]["scale_factor"])),
    ):
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]), err_msg=k)


def test_kp_detector(nets):
    _, _, jme, _, m_vars, _, tme = nets
    x = _images(3, 4)
    ref = jme.apply(m_vars, jnp.asarray(x), method="estimate_kp")
    with torch.no_grad():
        out = tme.estimate_kp(_nchw(x))
    for key in ("value", "jacobian"):
        _close(out[key], ref[key], 1e-4)


@pytest.mark.parametrize("pre_downsampled", [False, True])
def test_motion_estimator(nets, pre_downsampled):
    _, _, jme, _, m_vars, _, tme = nets
    src, drv = _images(1, 5), _images(2, 6)
    kp_s = jme.apply(m_vars, jnp.asarray(src), method="estimate_kp")
    kp_d = jme.apply(m_vars, jnp.asarray(drv), method="estimate_kp")
    kp_s = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (2,) + a.shape[1:]), kp_s)
    src_in = src
    if pre_downsampled:
        from synergize_motion_appearance_tpu.ops import antialias_downsample
        src_in = np.asarray(antialias_downsample(jnp.asarray(src), 0.25))
    ref = jme.apply(m_vars, kp_s, kp_d, jnp.asarray(src_in),
                    method="estimate_motion_w_kp",
                    pre_downsampled=pre_downsampled)
    to_t = lambda kp: {k: torch.from_numpy(np.array(v))  # noqa: E731
                       for k, v in kp.items()}
    with torch.no_grad():
        out = tme.estimate_motion_w_kp(to_t(kp_s), to_t(kp_d),
                                       _nchw(src_in),
                                       pre_downsampled=pre_downsampled)
    _close(out["deformation"], ref["deformation"], 1e-4)
    _close(_nhwc(out["occlusion_map"]), ref["occlusion_map"], 1e-4)
    _close(out["driving_kp_heatmap"], ref["driving_kp_heatmap"], 1e-4)


def _block_pair(jax_module, x_nhwc, map_fn, port_module, seed):
    """Init a JAX block, carry its params to the port block by map_fn
    (an _Exporter method), run both on x."""
    jvars = jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    jvars = _perturb(jvars, seed)
    e = weights._Exporter({"params": {"b": jvars["params"]}})
    map_fn(e)
    sd = {k[2:]: v for k, v in e.state_dict().items()}
    port_module.load_state_dict(sd, strict=True)
    ref = jax_module.apply(jvars, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out = port_module(_nchw(x_nhwc))
    return _nhwc(out), np.asarray(ref)


@pytest.mark.parametrize("kind", ["res", "res_same", "attn", "down", "up"])
def test_vqgan_blocks(kind):
    x = np.random.RandomState(7).randn(2, 8, 8, 16).astype(np.float32)
    jax_module, port_module, map_fn = {
        "res": (jvq.VQGANResBlock(32), tvq.VQGANResBlock(16, 32),
                lambda e: e.res_block("b", "b")),
        "res_same": (jvq.VQGANResBlock(16), tvq.VQGANResBlock(16, 16),
                     lambda e: e.res_block("b", "b")),
        "attn": (jvq.AttnBlock(), tvq.AttnBlock(16),
                 lambda e: (e.gn("b.norm", "b/norm"),
                            [e.conv2d(f"b.{n}", f"b/{n}")
                             for n in ("q", "k", "v", "proj_out")])),
        "down": (jvq.Downsample(), tvq.Downsample(16),
                 lambda e: e.conv2d("b.conv", "b/conv")),
        "up": (jvq.Upsample(), tvq.Upsample(16),
               lambda e: e.conv2d("b.conv", "b/conv")),
    }[kind]
    out, ref = _block_pair(jax_module, x, map_fn, port_module, seed=8)
    assert out.shape == ref.shape
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_layer(masked):
    B, t, E, H, K = 2, 4, 16, 4, 24
    rng = np.random.RandomState(9)
    tgt = rng.randn(B, t * t, E).astype(np.float32)
    ctx = rng.randn(K, E).astype(np.float32)
    pos = rng.randn(1, t * t, E).astype(np.float32)
    mask = rng.rand(B, t * t) < 0.3 if masked else None
    jl = JaxTransformerLayer(E, H, 2 * E)
    args = (jnp.asarray(tgt), jnp.asarray(ctx), (t, t))
    kw = dict(key_padding_mask=None if mask is None else jnp.asarray(mask),
              query_pos=jnp.asarray(pos))
    jvars = _perturb(jl.init(jax.random.PRNGKey(10), *args, **kw), 11)
    ref = jl.apply(jvars, *args, **kw)
    e = weights._Exporter({"params": {"b": jvars["params"]}})
    e.transformer_layer("b", "b")
    layer = TransformerLayer(E, H, 2 * E)
    layer.load_state_dict({k[2:]: v for k, v in e.state_dict().items()},
                          strict=True)
    with torch.no_grad():
        out = layer(torch.from_numpy(tgt), torch.from_numpy(ctx), (t, t),
                    key_padding_mask=(None if mask is None
                                      else torch.from_numpy(mask)),
                    query_pos=torch.from_numpy(pos))
    # measured error ~5e-7; the tanh form of GELU would give ~1e-4
    _close(out, ref, 1e-5)


def test_encode_source(nets):
    _, jg, _, g_vars, _, tg, _ = nets
    src = _images(1, 12)
    ref = jg.apply(g_vars, jnp.asarray(src), method="encode_source")
    with torch.no_grad():
        out = tg.encode_source(_nchw(src))
    _close(_nhwc(out["latent"]), ref["latent"], 1e-4)
    assert sorted(out["feats"]) == sorted(ref["feats"])
    for r in ref["feats"]:
        _close(_nhwc(out["feats"][r]), ref["feats"][r], 1e-4)


def test_generator_inference_call(nets):
    """AppMotionCompFormer(inference=True) on a batch-1 source and a
    batch-2 motion, from the same dense-motion inputs; the training
    forward on them gives the same frame."""
    _, jg, jme, g_vars, m_vars, tg, _ = nets
    src, drv = _images(1, 13), _images(2, 14)
    kp_s = jme.apply(m_vars, jnp.asarray(src), method="estimate_kp")
    kp_d = jme.apply(m_vars, jnp.asarray(drv), method="estimate_kp")
    kp_s = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (2,) + a.shape[1:]), kp_s)
    dm = jme.apply(m_vars, kp_s, kp_d, jnp.asarray(src),
                   method="estimate_motion_w_kp")
    ref = jg.apply(g_vars, jnp.asarray(src), dm, inference=True)
    dm_t = {
        "deformation": torch.from_numpy(np.array(dm["deformation"])),
        "occlusion_map": _nchw(dm["occlusion_map"]),
        "driving_kp_heatmap": torch.from_numpy(
            np.array(dm["driving_kp_heatmap"])),
    }
    with torch.no_grad():
        out = tg(_nchw(src), dm_t, inference=True)
    _close(_nhwc(out["out"]), ref["out"], 2e-4)
    for got, want in zip(out["deformation_list"], ref["deformation_list"]):
        _close(got, want, 2e-4)
    # the training forward (no gt): the same frame, on kernel K3's plain
    # version in the decoder region, plus the training outputs
    with torch.no_grad():
        train = tg(_nchw(src), dm_t, inference=False)
    _close(_nhwc(train["out"]), _nhwc(out["out"]), 1e-5)
    assert len(train["motion_recon_list"]) == 4
    assert "codebook_loss_app_list" not in train


@pytest.mark.parametrize("yml,name", [("tiny.yml", "tiny"),
                                      ("test.yml", "flagship_256")])
def test_build_network_takes_jax_options(yml, name):
    """The JAX package's option files build the same networks as the
    port's configs: build_network drops the keys that act only on a TPU
    (wl_*), and takes the ablation switches at their other values too."""
    yaml = pytest.importorskip("yaml")
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    with open(osp.join(root, "options", yml)) as f:
        opt = yaml.safe_load(f)
    opt["network_g"].update(wl_decoder=True, wl_train=True)
    for net in ("network_g", "network_motion_estimator"):
        with torch.device("meta"):  # structure only
            from_yml = build_network(opt[net])
            ours = build_network(configs.get(name)[net])
        assert {k: v.shape for k, v in from_yml.state_dict().items()} == {
            k: v.shape for k, v in ours.state_dict().items()}
    with torch.device("meta"):
        g = build_network(dict(opt["network_g"],
                               multiscale_feature_fusion=False))
        me = opt["network_motion_estimator"]
        me = build_network(dict(me, kp_detector_params=dict(
            me["kp_detector_params"], estimate_jacobian=False)))
    assert not any(k.startswith("fuse_ms_dict.") for k in g.state_dict())
    assert not any(".jacobian." in k for k in me.state_dict())
