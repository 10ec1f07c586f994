"""Port of kernel K1 (head-packed fused attention): its plain PyTorch
version against the JAX package's Pallas kernel run in interpret mode on
the CPU, the wrapper's CPU path, and the gradient.

Tolerances: both sides compute in float32 with the same formula but sum
in a different order, so outputs (of order 1) agree to 2e-5, the bound the
JAX package's own kernel-vs-dense test uses; gradients to 1e-5 likewise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops.fused_attention import (  # noqa: E402
    _dense_reference_packed,
    _fused_attention_packed_pallas,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

ATOL = RTOL = 2e-5


def _inputs(B, L, K, E, masked, shared, seed, all_masked_batch=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, L, E).astype(np.float32)
    kshape = (K, E) if shared else (B, K, E)
    k = rng.randn(*kshape).astype(np.float32)
    v = rng.randn(*kshape).astype(np.float32)
    bias = None
    if masked:
        bias = np.where(rng.rand(B, K) < 0.3, -1e30, 0.0).astype(np.float32)
        if all_masked_batch is not None:
            bias[all_masked_batch] = -1e30
    return q, k, v, bias


def _pallas(H, q, k, v, bias):
    out = _fused_attention_packed_pallas(
        H, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), interpret=True)
    return np.asarray(out)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize(
    "B,H,L,K,E,masked,shared",
    [
        (2, 8, 16, 24, 16, False, False),   # d = 2, per-batch k/v
        (2, 4, 16, 24, 8, True, True),      # d = 2, shared context, bias
        (2, 8, 32, 40, 32, False, True),    # d = 4 (motion layers), shared
        (2, 8, 32, 40, 32, True, False),    # d = 4, bias
        (1, 8, 32, 48, 256, False, True),   # d = 32 (appearance), shared
        (2, 8, 32, 32, 256, True, False),   # d = 32, self-attention + bias
    ],
)
def test_plain_matches_pallas_interpret(B, H, L, K, E, masked, shared):
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=B + H + K)
    ref = _pallas(H, q, k, v, bias)
    out = port.fused_attention_packed_reference(
        _t(q), _t(k), _t(v), _t(bias), num_heads=H).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_all_masked_row_gives_zero():
    """A batch row whose every key is masked outputs exactly 0, as the
    TPU kernel does (the JAX dense reference would give mean(v) there)."""
    q, k, v, bias = _inputs(3, 16, 24, 16, True, False, seed=7,
                            all_masked_batch=1)
    ref = _pallas(4, q, k, v, bias)
    out = port.fused_attention_packed_reference(
        _t(q), _t(k), _t(v), _t(bias), num_heads=4).numpy()
    np.testing.assert_array_equal(out[1], 0.0)
    np.testing.assert_array_equal(ref[1], 0.0)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shared", [False, True])
def test_wrapper_takes_plain_path_on_cpu(shared):
    q, k, v, bias = _inputs(2, 16, 24, 32, True, shared, seed=11)
    before = port.launches
    out = port.fused_attention_packed(_t(q), _t(k), _t(v), _t(bias),
                                      num_heads=8)
    ref = port.fused_attention_packed_reference(
        _t(q), _t(k), _t(v), _t(bias), num_heads=8)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert port.launches == before  # no kernel launch for CPU tensors


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError):
        port.fused_attention_packed(q, torch.zeros(3, 8, 32),
                                    torch.zeros(3, 8, 32), num_heads=8)
    with pytest.raises(ValueError):
        port.fused_attention_packed(q, torch.zeros(8, 32),
                                    torch.zeros(8, 32), num_heads=5)


@pytest.mark.parametrize("masked,shared", [(False, False), (True, True)])
def test_backward_matches_jax_vjp(masked, shared):
    B, H, L, K, E = 2, 4, 16, 24, 16
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=13)
    g = np.random.RandomState(14).randn(B, L, E).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: _dense_reference_packed(
            H, q_, k_, v_, None if bias is None else jnp.asarray(bias)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = port.fused_attention_packed(qt, kt, vt, _t(bias), num_heads=H)
    out.backward(_t(g))
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
