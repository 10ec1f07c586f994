"""The gradient of kernel K1's wrapper on an all-masked row, on the CPU.

A batch row whose every key carries the -1e30 bias outputs exactly 0, as
the TPU kernel does (``fused_attention.py:92-95, 260-261``;
tests/test_torch_attention.py::test_all_masked_row_gives_zero). The
port's backward differentiates its plain version, which gives that row
zero weights, so the row's dq, dk and dv are exactly 0 here.

The JAX package differs there: its custom VJP (``fused_attention.py:
339-346``) differentiates the dense reference, whose softmax over equal
scores is uniform (``nan_to_num`` never fires), so the row gets dv = g/K
per key (g summed over the row's queries) and a nonzero dq. This test
pins the port's zero and records the JAX values; on every other row the
two gradients agree to float32 rounding (1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops.fused_attention import (  # noqa: E402
    _dense_reference_packed,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

B, L, K, E, H = 2, 8, 6, 16, 4


def test_all_masked_row_has_zero_gradient():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, n, E).astype(np.float32) for n in (L, K, K))
    g = rng.randn(B, L, E).astype(np.float32)
    bias = np.zeros((B, K), np.float32)
    bias[1] = -1e30  # every key of batch row 1 masked

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fused_attention.fused_attention_packed(
        tq, tk, tv, torch.from_numpy(bias), num_heads=H)
    out.backward(torch.from_numpy(g))
    for t in (tq, tk, tv):
        assert torch.equal(t.grad[1], torch.zeros_like(t.grad[1]))
    assert torch.equal(out[1], torch.zeros_like(out[1]))

    _, vjp = jax.vjp(lambda *a: _dense_reference_packed(
        H, *a, jnp.asarray(bias)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jdq, jdk, jdv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    # the JAX VJP's uniform weights: dv = g summed over queries / K
    np.testing.assert_allclose(
        jdv[1], np.broadcast_to(g[1].sum(0) / K, (K, E)), rtol=1e-5,
        atol=1e-6)
    assert np.abs(jdq[1]).max() > 0
    for got, want in ((tq, jdq), (tk, jdk), (tv, jdv)):
        np.testing.assert_allclose(got.grad[0].numpy(), want[0], rtol=1e-5,
                                   atol=1e-5)
