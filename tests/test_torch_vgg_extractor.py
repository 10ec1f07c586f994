"""The port's named-layer ``VGGFeatureExtractor`` against the JAX
package's module, on the CPU at 32x32: vgg11 and vgg19 taps, and
``range_norm`` + ``remove_pooling`` + ``pooling_stride`` 1. The JAX
params are ``jax.eval_shape`` of its init filled from a numpy seed,
carried to the port by ``weights.network_state_dict`` and loaded with
``strict=True`` (so the port builds exactly the layers the JAX module
has: up to the deepest tap). JAX runs un-jitted. Bounds: rtol and atol
2e-4, those of tests/test_vgg_extractor.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build_network,
)
from synergize_motion_appearance_tpu_torch import weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    build_network,
)

from test_torch_vqgan_extras import (  # noqa: E402,F401
    random_params,
    two_torch_threads,
)

CASES = {
    "vgg11": dict(layer_name_list=["relu1_1", "conv3_2", "pool3",
                                   "relu4_1"], vgg_type="vgg11"),
    "vgg19": dict(layer_name_list=["relu1_1", "relu2_1", "conv3_4",
                                   "relu4_4", "relu5_1"], vgg_type="vgg19"),
    "options": dict(layer_name_list=["relu2_2", "relu3_1"],
                    vgg_type="vgg16", range_norm=True, remove_pooling=False,
                    pooling_stride=1, use_input_norm=False),
    "no_pooling": dict(layer_name_list=["relu3_1"], vgg_type="vgg19",
                       range_norm=True, remove_pooling=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vgg_feature_extractor_matches_jax(case):
    cfg = dict(type="VGGFeatureExtractor", **CASES[case])
    x = np.random.RandomState(0).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    jm = jax_build_network(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": random_params(shapes["params"], 1)}
    net = build_network(cfg).eval()
    net.load_state_dict(weights.network_state_dict(variables, cfg),
                        strict=True)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert list(got) == [n for n in net.vgg_net._modules
                         if n in cfg["layer_name_list"]]
    assert set(got) == set(want) == set(cfg["layer_name_list"])
    for name in want:
        np.testing.assert_allclose(got[name].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[name]), rtol=2e-4,
                                   atol=2e-4)
    if cfg.get("remove_pooling"):
        assert got["relu3_1"].shape == (1, 256, 32, 32)


def test_unknown_layer_raises():
    with pytest.raises(ValueError, match="not in"):
        build_network(dict(type="VGGFeatureExtractor",
                           layer_name_list=["conv9_9"]))
