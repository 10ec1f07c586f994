"""Port of kernel K2 (fused attention in the head-split layout): its plain
PyTorch version against the JAX package's Pallas kernel ``_attn_kernel``
run in interpret mode on the CPU, the wrapper's CPU path, and the gradient
against ``jax.grad`` of the JAX package's ``fused_attention``.

Tolerances are kernel K1's (tests/test_torch_attention.py): both sides
compute in float32 with the same formula but sum in a different order, so
outputs (of order 1) agree to 2e-5 and gradients to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops.fused_attention import (  # noqa: E402
    _fused_attention_pallas,
    fused_attention as jax_fused_attention,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

ATOL = RTOL = 2e-5


def _inputs(B, H, L, K, d, masked, shared, seed, all_masked_batch=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, L, d).astype(np.float32)
    kshape = (1 if shared else B, H, K, d)
    k = rng.randn(*kshape).astype(np.float32)
    v = rng.randn(*kshape).astype(np.float32)
    bias = None
    if masked:
        bias = np.where(rng.rand(B, K) < 0.3, -1e30, 0.0).astype(np.float32)
        if all_masked_batch is not None:
            bias[all_masked_batch] = -1e30
    return q, k, v, bias


def _pallas(q, k, v, bias):
    out = _fused_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), interpret=True)
    return np.asarray(out)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize(
    "B,H,L,K,d,masked,shared",
    [
        (2, 8, 16, 24, 4, False, False),   # d = 4, per-batch k/v
        (2, 8, 16, 21, 4, True, True),     # d = 4, ragged K, shared, bias
        (1, 4, 24, 40, 8, False, True),    # d = 8, shared, B = 1
        (3, 2, 16, 13, 8, True, False),    # d = 8, ragged K, bias
        (2, 8, 32, 48, 32, False, True),   # d = 32 (appearance), shared
        (2, 8, 32, 37, 32, True, False),   # d = 32, ragged K, bias
    ],
)
def test_plain_matches_pallas_interpret(B, H, L, K, d, masked, shared):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared,
                            seed=B + H + K + d)
    ref = _pallas(q, k, v, bias)
    out = port.fused_attention_reference(_t(q), _t(k), _t(v),
                                         _t(bias)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_all_masked_row_gives_zero():
    """A batch row whose every key is masked outputs exactly 0, as the TPU
    kernel does (`_attn_kernel`'s (m > -1e29) factor)."""
    q, k, v, bias = _inputs(3, 4, 16, 24, 8, True, False, seed=7,
                            all_masked_batch=1)
    ref = _pallas(q, k, v, bias)
    out = port.fused_attention_reference(_t(q), _t(k), _t(v),
                                         _t(bias)).numpy()
    np.testing.assert_array_equal(out[1], 0.0)
    np.testing.assert_array_equal(ref[1], 0.0)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_packed_reference_is_the_split_one_relaid():
    """K1's plain version is K2's on the heads split out of E."""
    B, H, L, K, d = 2, 4, 12, 10, 8
    q, k, v, bias = _inputs(B, H, L, K, d, True, False, seed=5)
    packed = port.fused_attention_packed_reference(
        _t(q).permute(0, 2, 1, 3).reshape(B, L, H * d),
        _t(k).permute(0, 2, 1, 3).reshape(B, K, H * d),
        _t(v).permute(0, 2, 1, 3).reshape(B, K, H * d), _t(bias),
        num_heads=H)
    split = port.fused_attention_reference(_t(q), _t(k), _t(v), _t(bias))
    torch.testing.assert_close(
        packed, split.permute(0, 2, 1, 3).reshape(B, L, H * d), atol=0,
        rtol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_wrapper_takes_plain_path_on_cpu(shared):
    q, k, v, bias = _inputs(2, 4, 16, 24, 8, True, shared, seed=11)
    port.reset_launches()
    out = port.fused_attention(_t(q), _t(k), _t(v), _t(bias))
    ref = port.fused_attention_reference(_t(q), _t(k), _t(v), _t(bias))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    # no kernel launch for CPU tensors
    assert port.split_launches == 0 and port.launches == 0


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 4, 8, 8)
    with pytest.raises(ValueError, match="B, H, L, d"):
        port.fused_attention(torch.zeros(2, 8, 32), q, q)
    with pytest.raises(ValueError, match="do not match"):
        port.fused_attention(q, torch.zeros(3, 4, 8, 8),
                             torch.zeros(3, 4, 8, 8))
    with pytest.raises(ValueError, match="do not match"):
        port.fused_attention(q, torch.zeros(2, 4, 8, 4),
                             torch.zeros(2, 4, 8, 4))
    with pytest.raises(ValueError, match="bias"):
        port.fused_attention(q, q, q, torch.zeros(2, 7))


@pytest.mark.parametrize("masked,shared", [(False, False), (True, True),
                                           (True, False)])
def test_backward_matches_jax_grad(masked, shared):
    """The gradient differentiates the plain version, as the JAX custom
    VJP differentiates `_dense_reference`. No row is all-masked: there the
    JAX CPU path (the dense reference) gives the mean of v, not 0."""
    B, H, L, K, d = 2, 4, 16, 24, 8
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=13)
    g = np.random.RandomState(14).randn(B, H, L, d).astype(np.float32)
    jb = None if bias is None else jnp.asarray(bias)

    def loss(q_, k_, v_):
        return jnp.sum(jax_fused_attention(q_, k_, v_, jb) * g)

    ref = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = port.fused_attention(qt, kt, vt, _t(bias))
    out.backward(_t(g))
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
