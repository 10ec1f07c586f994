"""The VQGAN family of the port against the JAX package's, on the CPU:
``VQAutoEncoder`` and ``AutoEncoder_MSDecoder`` built by ``build_network``
from the JAX config keys at 32x32, ``GumbelQuantizer`` in eval and in
training, and ``FuseFeatBlock``.

Weights. The JAX trees come from ``jax.eval_shape`` of each module's init
(which compiles nothing), filled from a numpy seed (``random_params``):
kernels normal over sqrt(fan-in), biases and norm shifts 0.1-normal,
norm scales 1 + 0.1-normal, codebooks standard normal so that the
nearest entry of a latent is well apart from the next. They reach the
port through ``weights.network_state_dict``, loaded with ``strict=True``.
JAX runs un-jitted. The Gumbel noise of the training quantizer is JAX's
draw from its key, patched into the port's draw.

Tolerances (float32 on both sides): outputs within 1e-4 of the largest
output magnitude (the two frameworks sum convolutions in other orders);
the VQ and Gumbel indices exact; the codebook and KL losses within 1e-5
relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu import models as jmodels  # noqa: E402
from synergize_motion_appearance_tpu_torch import models, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    vqgan_extras,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

TOL = 1e-4
LOSS_REL = 1e-5


VQ_CFG = dict(type="VQAutoEncoder", img_size=32, nf=8, ch_mult=[1, 2],
              res_blocks=1, attn_resolutions=[16], codebook_size=32,
              emb_dim=16)
MS_CFG = dict(type="AutoEncoder_MSDecoder", img_size=32, nf=8,
              ch_mult=[1, 2, 2, 4], res_blocks=1, attn_resolutions=[4],
              emb_dim=16)


def random_params(shapes, seed):
    """A tree of numpy float32 arrays of the shapes of ``shapes`` (the
    output of ``jax.eval_shape``), filled by leaf name."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("embedding", "embed"):
            a = rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nets(cfg, jax_module, x, seed, **kw):
    """(JAX variables, the port's module with the same weights)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), **kw)
    variables = {"params": random_params(shapes["params"], seed)}
    net = (models.build_network(cfg) if cfg["type"] in
           models.ARCH_REGISTRY.keys() else
           getattr(vqgan_extras, cfg["type"])(**cfg["args"]))
    net.load_state_dict(weights.network_state_dict(variables, cfg),
                        strict=True)
    return variables, net.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _image(n, size, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def test_vq_autoencoder_matches_jax():
    x = _image(2, 32, 0)
    jm = jmodels.build_network(VQ_CFG)
    variables, net = nets(VQ_CFG, jm, x, 1)
    out_j, loss_j, stats_j = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t, loss_t, stats_t = net(_nchw(x))
    _close(_nhwc(out_t), out_j)
    np.testing.assert_array_equal(
        stats_t["min_encoding_indices"].numpy(),
        np.asarray(stats_j["min_encoding_indices"]))
    assert len(np.unique(stats_t["min_encoding_indices"].numpy())) > 4
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_REL)


def test_autoencoder_ms_decoder_matches_jax():
    x = _image(1, 32, 2)
    jm = jmodels.build_network(MS_CFG)
    variables, net = nets(MS_CFG, jm, x, 3)
    assert any(k.startswith("generator.b0_attn_a.") for k in net.state_dict())
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(_nchw(x))
    assert got.shape == (1, 3, 32, 32)
    _close(_nhwc(got), want)


GUMBEL = dict(codebook_size=16, emb_dim=8, num_hiddens=12, kl_weight=5e-4,
              temp_init=0.7)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("straight_through", [False, True])
def test_gumbel_quantizer_matches_jax(monkeypatch, train, straight_through):
    kw = dict(GUMBEL, straight_through=straight_through)
    z = np.random.RandomState(4).standard_normal((2, 6, 6, 12)).astype(
        np.float32)
    jm = jmodels.GumbelQuantizer(**kw)
    key = jax.random.PRNGKey(5)
    variables, net = nets({"type": "GumbelQuantizer", "args": kw}, jm, z, 6)
    rngs = {"gumbel": key} if train else {}
    noise = {}
    zq_j, diff_j, st_j = jm.apply(variables, jnp.asarray(z), train=train,
                                  rngs=rngs)
    if train:
        def draw(shape, generator, device, dtype):
            assert generator is not None
            noise["drawn"] = True
            return _nchw(jm.apply(variables, jnp.asarray(z), train=True,
                                  rngs=rngs, method=_gumbel_noise))

        monkeypatch.setattr(vqgan_extras, "_draw_gumbel", draw)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        zq_t, diff_t, st_t = net(_nchw(z), train=train, generator=gen)
    if train:
        assert noise, "the port did not draw its Gumbel noise"
    _close(_nhwc(zq_t), zq_j, 1e-5)
    np.testing.assert_array_equal(st_t["min_encoding_indices"].numpy(),
                                  np.asarray(st_j["min_encoding_indices"]))
    np.testing.assert_allclose(float(diff_t), float(diff_j), rtol=LOSS_REL)


def _gumbel_noise(module, z, train):
    """What GumbelQuantizer.__call__ draws: its first key of the 'gumbel'
    stream, at the logits' shape."""
    return jax.random.gumbel(module.make_rng("gumbel"),
                             z.shape[:3] + (module.codebook_size,),
                             jnp.float32)


def test_gumbel_quantizer_eval_is_deterministic():
    net = vqgan_extras.GumbelQuantizer(**GUMBEL).eval()
    z = torch.randn(1, 12, 4, 4, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        a = net(z)[0]
        b = net(z, generator=torch.Generator().manual_seed(8))[0]
    assert torch.equal(a, b)


def test_fuse_feat_block_matches_jax():
    rng = np.random.RandomState(8)
    enc = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    dec = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = jmodels.FuseFeatBlock(out_ch=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(enc),
                            jnp.asarray(dec))
    variables = {"params": random_params(shapes["params"], 9)}
    net = vqgan_extras.FuseFeatBlock(16)
    net.load_state_dict(weights.network_state_dict(
        variables, {"type": "FuseFeatBlock"}), strict=True)
    want = jm.apply(variables, jnp.asarray(enc), jnp.asarray(dec))
    with torch.no_grad():
        got = net(_nchw(enc), _nchw(dec))
    _close(_nhwc(got), want)
