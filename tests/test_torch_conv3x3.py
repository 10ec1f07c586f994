"""Kernel K3's plain version and its autograd Function against the JAX
package's ``conv3x3_wl_ad`` (the Pallas 3x3 conv in interpret mode, with
its custom VJP), on the CPU, where ``ops.conv3x3`` runs its plain version.

Tolerance 3e-5 (as tests/test_wl_decoder.py holds conv3x3_wl_ad against
XLA's conv): both sides sum the 9 * C products in float32 in different
orders, which leaves ~1e-6 here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.models.layers import (  # noqa: E402
    from_wl,
    to_wl,
)
from synergize_motion_appearance_tpu.ops.pallas_conv_wl import (  # noqa: E402
    conv3x3_wl_ad,
)
from synergize_motion_appearance_tpu_torch.models import layers  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

B, H, W, CI, CO = 2, 8, 16, 8, 12
TOL = 3e-5


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, CI).astype(np.float32)
    w = (0.2 * rng.randn(3, 3, CI, CO)).astype(np.float32)      # HWIO
    b = (0.1 * rng.randn(CO)).astype(np.float32)
    dy = rng.randn(B, H, W, CO).astype(np.float32)
    return x, w, b, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.fixture(scope="module")
def jax_result():
    """y, dx, dw, db of conv3x3_wl_ad(interpret=True), NHWC / HWIO."""
    x, w, b, dy = _inputs()

    def f(x, w, b):
        return from_wl(conv3x3_wl_ad(4, True, to_wl(x), w, b))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(dy))
    return tuple(np.asarray(a) for a in (y, dx, dw, db))


def test_reference_forward_matches_pallas(jax_result):
    x, w, b, _ = _inputs()
    y = k3.conv3x3_reference(_nchw(x), _oihw(w), torch.from_numpy(b))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), jax_result[0],
                               rtol=TOL, atol=TOL)


def test_autograd_matches_pallas_vjp(jax_result):
    """Forward, dx (the plain version on dy with rotated, channel-swapped
    weights), dw (9 shifted contractions) and db."""
    x, w, b, dy = _inputs()
    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    k3.reset_launches()
    y = k3.conv3x3(xt, wt, bt)
    y.backward(_nchw(dy))
    assert k3.launches == 0  # the CPU runs the plain version
    y_ref, dx_ref, dw_ref, db_ref = jax_result
    for got, want, name in (
            (y.detach().permute(0, 2, 3, 1), y_ref, "y"),
            (xt.grad.permute(0, 2, 3, 1), dx_ref, "dx"),
            (wt.grad.permute(2, 3, 1, 0), dw_ref, "dw"),
            (bt.grad, db_ref, "db")):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(1, 3, 5, 7, 4), (2, 16, 9, 33, 20)])
def test_reference_and_grads_match_conv2d(shape, bias):
    """Ragged shapes (no tile multiple anywhere) against F.conv2d and its
    autograd, in float64 so that only the algorithm is compared."""
    n, c, h, w_, co = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, c, h, w_, generator=g, dtype=torch.float64)
    w = torch.randn(co, c, 3, 3, generator=g, dtype=torch.float64)
    b = torch.randn(co, generator=g, dtype=torch.float64) if bias else None
    dy = torch.randn(n, co, h, w_, generator=g, dtype=torch.float64)
    got = [t.clone().requires_grad_() if t is not None else None
           for t in (x, w, b)]
    want = [t.clone().requires_grad_() if t is not None else None
            for t in (x, w, b)]
    k3.conv3x3(*got).backward(dy)
    torch.nn.functional.conv2d(want[0], want[1], want[2],
                               padding=1).backward(dy)
    for a, e in zip(got, want):
        if a is not None:
            torch.testing.assert_close(a.grad, e.grad, rtol=1e-10,
                                       atol=1e-10)


def test_bfloat16_rounds_once():
    """A bfloat16 call accumulates in float32 and rounds once: it equals
    the float32 result of the same bf16 inputs, rounded to bf16."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 5, 9, generator=g).bfloat16()
    w = torch.randn(7, 6, 3, 3, generator=g).bfloat16()
    b = torch.randn(7, generator=g).bfloat16()
    y = k3.conv3x3(x, w, b)
    assert y.dtype == torch.bfloat16
    y32 = k3.conv3x3(x.float(), w.float(), b.float())
    assert torch.equal(y, y32.bfloat16())


def test_shape_checks():
    x = torch.zeros(1, 4, 5, 5)
    with pytest.raises(ValueError, match="input channels"):
        k3.conv3x3(x, torch.zeros(3, 5, 3, 3))
    with pytest.raises(ValueError, match="Cout, C, 3, 3"):
        k3.conv3x3(x, torch.zeros(3, 4, 1, 1))
    with pytest.raises(ValueError, match="bias"):
        k3.conv3x3(x, torch.zeros(3, 4, 3, 3), torch.zeros(4))


def test_region_routes_only_3x3_stride1_pad1(monkeypatch):
    """Inside ``decoder_region`` a 3x3/s1/p1 ``layers.Conv2d`` goes
    through K3; outside it, and for every other conv inside it, the conv
    is ``nn.Conv2d``'s."""
    calls = []
    real = layers.conv3x3

    def spy(x, w, b=None):
        calls.append(tuple(w.shape))
        return real(x, w, b)

    monkeypatch.setattr(layers, "conv3x3", spy)
    torch.manual_seed(0)
    x = torch.randn(2, 4, 6, 6)
    convs = [layers.Conv2d(4, 5, 3, padding=1),
             layers.Conv2d(4, 5, 1),
             layers.Conv2d(4, 5, 3, stride=2, padding=1)]
    outside = [c(x) for c in convs]
    assert calls == []
    with layers.decoder_region():
        inside = [c(x) for c in convs]
        with layers.decoder_region(False):
            convs[0](x)
    assert calls == [(5, 4, 3, 3)]
    for a, e in zip(inside, outside):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)
