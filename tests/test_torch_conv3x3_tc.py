"""Host-side code of the bfloat16 tensor-core conv (kernels K3 and K4):
the weight packing and the tile choice of ``ops/conv3x3.py``, and the
input gradient's entry, on the CPU.

The kernel multiplies each tap's shifted input window by a (Cout, C) slice
of the packed weights (``pack_weights_reference`` is the packing's plain
version). Emulating that as 9 shifted float64 matmuls over the packed
weights must give the conv itself (forward and NHWC) and the autograd
input gradient of ``F.conv2d`` (the rotated, channel-swapped packing), at
ragged shapes; float64, so that only the index arithmetic is compared
(tolerance 1e-10).
"""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

# (B, C, Cout, H, W): C not a multiple of 8 or 16, Cout above one tile
SHAPES = [(1, 3, 5, 7, 9), (2, 20, 40, 6, 11), (1, 17, 130, 5, 4)]


def _taps_conv(x, packed, cout):
    """The kernel's arithmetic in float64: y[b, o] = sum over taps of the
    shifted window of x times packed[tap, o, :C]."""
    B, C, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    y = x.new_zeros(B, cout, H, W)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        y += torch.einsum("bchw,oc->bohw", xp[:, :, ky:ky + H, kx:kx + W],
                          packed[tap, :cout, :C])
    return y


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_forward_is_the_conv(shape):
    B, C, Cout, H, W = shape
    x, w = _rand((B, C, H, W), 1), _rand((Cout, C, 3, 3), 2)
    got = _taps_conv(x, k3.pack_weights_reference(w, k3.PACK_OIHW), Cout)
    torch.testing.assert_close(got, k3.conv3x3_reference(x, w),
                               rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got, F.conv2d(x, w, padding=1),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_flip_is_the_input_gradient(shape):
    """The rotated, channel-swapped packing of w, applied to dy, is the
    autograd input gradient of the conv with w."""
    B, C, Cout, H, W = shape
    x = _rand((B, C, H, W), 3).requires_grad_()
    w, dy = _rand((Cout, C, 3, 3), 4), _rand((B, Cout, H, W), 5)
    F.conv2d(x, w, padding=1).backward(dy)
    got = _taps_conv(dy, k3.pack_weights_reference(w, k3.PACK_FLIP), C)
    torch.testing.assert_close(got, x.grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(k3.conv3x3_input_grad(dy, w), x.grad,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_hwio_is_the_nhwc_conv(shape):
    B, C, Cout, H, W = shape
    x, w = _rand((B, H, W, C), 6), _rand((3, 3, C, Cout), 7)
    x_nchw = x.permute(0, 3, 1, 2)
    got = _taps_conv(x_nchw, k3.pack_weights_reference(w, k3.PACK_HWIO),
                     Cout)
    torch.testing.assert_close(
        got, F.conv2d(x_nchw, w.permute(3, 2, 0, 1), padding=1),
        rtol=1e-10, atol=1e-10)


def test_packing_pads_with_zeros():
    w = _rand((130, 20, 3, 3), 9)
    packed = k3.pack_weights_reference(w, k3.PACK_OIHW)
    assert packed.shape == (9, 2 * k3.PACK_CO, 2 * k3.PACK_CI)
    assert packed[:, 130:].abs().max() == 0
    assert packed[:, :, 20:].abs().max() == 0
    assert torch.equal(packed[4, :130, :20], w[:, :, 1, 1])
    with pytest.raises(ValueError, match="packing mode"):
        k3.pack_weights_reference(w, 3)


@pytest.mark.parametrize("case", [
    # (B, H, W, Cout, SMs) -> tile: the training step's shapes on 132 SMs
    ((2, 256, 256, 64, 132), 1), ((2, 256, 256, 128, 132), 0),
    ((2, 128, 128, 128, 132), 0), ((2, 64, 64, 128, 132), 2),
    ((2, 64, 64, 256, 132), 2),
    # a grid of exactly as many blocks as SMs keeps the large tile
    ((1, 2, 64 * 33, 512, 132), 0), ((1, 2, 64 * 33, 384, 132), 2),
    ((1, 7, 9, 5, 132), 2)], ids=str)
def test_choose_tile(case):
    (B, H, W, Cout, sms), want = case
    assert k3.choose_tile(B, H, W, Cout, sms) == want


def test_tile_blocks_cover_the_output():
    """Each tile's grid covers every output row, column and channel."""
    for tile, (th, tw, bn) in enumerate(k3.TILES):
        assert k3._blocks(tile, 3, 17, 33, 130) == (
            3 * -(-17 // th) * -(-33 // tw) * -(-130 // bn))
        assert k3.PACK_CO % bn == 0 and tw % 16 == 0


def test_input_grad_checks_shapes():
    with pytest.raises(ValueError, match="dy"):
        k3.conv3x3_input_grad(torch.zeros(1, 4, 5, 5),
                              torch.zeros(3, 2, 3, 3))
