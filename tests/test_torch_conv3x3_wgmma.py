"""Host-side code of the bfloat16 wgmma conv (kernels K3 and K4,
``csrc/conv3x3_wgmma.cu``), on the CPU: ``plan``'s choice of kernel, the
wgmma tile choice, and the kernel's tiling emulated in float32.

The emulation follows the kernel's index arithmetic: per block of
WGMMA_TILES, per chunk of WGMMA_CHUNK input channels, the halo tile as TMA
stages it ((rows + 2) x pitch pixels from (y0 - 1, x0 - left), with
(pitch, left) = WGMMA_HALO[layout], zero outside x and past C; in NCHW
channel-major and then transposed in 8 x 8 blocks, as the transposer warps
do), each tap's A operand the 64 pixel rows from row (t + ky) * pitch +
left - 1 + kx of that tile, its B operand the packed
weights of the tap (zero past Cp and Coutp, as TMA fills them), the bias
added once, the output masked to the tensor. It must give
``conv3x3_reference`` (forward and, on the flipped packing, input
gradient) and ``conv3x3_nhwc_reference`` to 1e-5: float32 sums of the same
products in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from synergize_motion_appearance_tpu_torch import configs  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import conv3x3 as k3  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

TRAIN_CONVS = chip_smoke.k3_forward_convs(
    configs.get("flagship_train")["network_g"])
# (B, C, Cout, H, W) of every forward and input-gradient launch of one
# flagship train step (the input gradient runs the conv Cout -> C)
PATH_CASES = sorted({(kind, (2, c, co, h, h) if kind == "forward"
                      else (2, co, c, h, h))
                     for c, co, h in TRAIN_CONVS
                     for kind in ("forward", "dgrad")})
SMS = 132  # an H100 SXM's SMs
ALIGNED = (0, 256)  # addresses of x and y


def _id(case):
    kind, (B, C, Cout, H, W) = case
    return f"{kind}-{C}to{Cout}@{H}"


def test_path_cases_are_the_launch_shapes():
    assert len(PATH_CASES) == 16
    shapes = {shape[:3] + shape[3:] for _, shape in PATH_CASES}
    assert {s[:5] for s in chip_smoke.k3_launch_shapes(
        configs.get("flagship_train")["network_g"], 2, "bfloat16")} == shapes


@pytest.mark.parametrize("layout", [k3.NCHW, k3.NHWC], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("case", PATH_CASES, ids=_id)
def test_plan_sends_the_train_step_to_wgmma(case, layout):
    """Every train-step launch runs the wgmma kernel; its NCHW 64-output-
    channel convs (all at 256^2, 1024 blocks) in the paired geometry."""
    _, (B, C, Cout, H, W) = case
    p = k3.plan(torch.bfloat16, layout, B, C, H, W, Cout, SMS, ALIGNED)
    assert p == k3.Plan("wgmma", k3.choose_wgmma_tile(B, H, W, Cout, SMS),
                        layout == k3.NCHW and Cout == 64)


@pytest.mark.parametrize("case", [
    # (layout, B, C, Cout, H, W) -> (tile, pair)
    ((k3.NCHW, 2, 64, 64, 256, 256), (1, True)),
    ((k3.NHWC, 2, 64, 64, 256, 256), (1, False)),   # NHWC never pairs
    ((k3.NCHW, 2, 128, 128, 64, 64), (1, False)),   # 128 blocks < 2 x 132
    ((k3.NCHW, 2, 128, 128, 128, 128), (0, False)),  # 128-channel tile
    ((k3.NCHW, 1, 16, 40, 4, 132 * 64), (1, True)),  # 264 blocks
    ((k3.NCHW, 1, 16, 40, 4, 131 * 64), (1, False))], ids=str)  # 262
def test_plan_pairs_blocks_where_the_grid_allows(case):
    (layout, B, C, Cout, H, W), (tile, pair) = case
    assert k3.plan(torch.bfloat16, layout, B, C, H, W, Cout, SMS,
                   ALIGNED) == k3.Plan("wgmma", tile, pair)


@pytest.mark.parametrize("shape", chip_smoke.RAGGED_CONVS,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_on_ragged_shapes(shape):
    """TMA needs an NCHW row (W) or an NHWC pixel (C) of whole 16-byte
    units; the other bf16 shapes keep the mma.sync kernel."""
    B, C, Cout, H, W = shape
    for layout, row in ((k3.NCHW, W), (k3.NHWC, C)):
        p = k3.plan(torch.bfloat16, layout, B, C, H, W, Cout, SMS, ALIGNED)
        assert p.kernel == ("wgmma" if row % 8 == 0 else "mma"), layout
        if p.kernel == "mma":
            assert p.tile == k3.choose_tile(B, H, W, Cout, SMS)


@pytest.mark.parametrize("pointers", [(8, 0), (0, 2), (16, 40)], ids=str)
def test_plan_on_misaligned_pointers(pointers):
    B, C, Cout, H, W = 2, 128, 128, 64, 64
    for layout in (k3.NCHW, k3.NHWC):
        assert k3.plan(torch.bfloat16, layout, B, C, H, W, Cout, SMS,
                       pointers).kernel == "mma"


@pytest.mark.parametrize("shape", [c[1] for c in PATH_CASES[:3]]
                         + chip_smoke.RAGGED_CONVS,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_float32_is_the_cuda_core_kernel(shape):
    B, C, Cout, H, W = shape
    for layout in (k3.NCHW, k3.NHWC):
        assert k3.plan(torch.float32, layout, B, C, H, W, Cout, SMS,
                       (8, 2)) == k3.Plan("f32", 0)
    with pytest.raises(TypeError, match="float16"):
        k3.plan(torch.float16, k3.NCHW, B, C, H, W, Cout, SMS, ALIGNED)


@pytest.mark.parametrize("case", [
    # (B, H, W, Cout) -> tile on 132 SMs: the train step's shapes
    ((2, 256, 256, 64), 1), ((2, 256, 256, 128), 0),
    ((2, 128, 128, 128), 0), ((2, 128, 128, 256), 0),
    ((2, 64, 64, 128), 1), ((2, 64, 64, 256), 0),
    # a grid of as many blocks as SMs keeps the large tile; one of fewer
    # blocks than SMs takes the 1-row 64-channel tile, whose blocks do a
    # quarter of the work in one wave all the same
    ((1, 2 * 132, 64, 128), 0), ((1, 2, 64, 128), 3), ((1, 7, 9, 5), 3)],
    ids=str)
def test_choose_wgmma_tile(case):
    (B, H, W, Cout), want = case
    assert k3.choose_wgmma_tile(B, H, W, Cout, SMS) == want


def test_wgmma_tiles_cover_the_output():
    """The kernel's grid (tiles_w * tiles_h, ceil(Cout / BN), B) writes
    every output element once; its tiles are what the kernel's wgmma and
    staging take."""
    B, H, W, Cout = 2, 5, 136, 130
    for tile, (th, tw, bn) in enumerate(k3.WGMMA_TILES):
        assert tw == 64 and bn in (64, 128) and th in (1, 2)
        hits = torch.zeros(B, Cout, H, W, dtype=torch.int32)
        tiles_w = -(-W // tw)
        for bx in range(tiles_w * -(-H // th)):
            y0, x0 = (bx // tiles_w) * th, (bx % tiles_w) * tw
            for n0 in range(0, Cout, bn):
                hits[:, n0:n0 + bn, y0:y0 + th, x0:x0 + tw] += 1
        assert bool((hits == 1).all()), tile
        assert k3._blocks(tile, B, H, W, Cout, k3.WGMMA_TILES) == (
            B * -(-H // th) * tiles_w * -(-Cout // bn))
    # a pixel row of a chunk is one 128-byte swizzle row; a halo row holds
    # the tile's columns and both neighbours, in whole 8-pixel runs; an
    # NCHW box starts on a 16-byte boundary
    assert k3.WGMMA_CHUNK * 2 == 128
    for layout, (pitch, left) in k3.WGMMA_HALO.items():
        assert left >= 1 and pitch >= left + 64 + 1 and pitch % 8 == 0
    assert k3.WGMMA_HALO[k3.NCHW][1] % 8 == 0


# ---------------------------------------------------------------------------
# the kernel's tiling, emulated
# ---------------------------------------------------------------------------

def _window(x, c0, gy0, gx0, rows, pw):
    """What a tensor map's box reads of x (C, H, W): WGMMA_CHUNK channels
    from c0, ``rows`` rows from gy0, ``pw`` pixels from gx0, zero outside
    x; as (channels, rows, pixels)."""
    C, H, W = x.shape
    kc = k3.WGMMA_CHUNK
    out = x.new_zeros(kc, rows, pw)
    ya, yb = max(gy0, 0), min(gy0 + rows, H)
    xa, xb = max(gx0, 0), min(gx0 + pw, W)
    cb = min(C, c0 + kc)
    if ya < yb and xa < xb and c0 < cb:
        out[:cb - c0, ya - gy0:yb - gy0, xa - gx0:xb - gx0] = \
            x[c0:cb, ya:yb, xa:xb]
    return out


def _halo_nchw(x, c0, gy0, gx0, rows, pw):
    """The NCHW staging of a chunk: one box (pw pixels, 1 row, WGMMA_CHUNK
    channels) per halo row, channel-major, as (rows, channels, pixels)."""
    return _window(x, c0, gy0, gx0, rows, pw).permute(1, 0, 2)


def _transpose(raw):
    """The transposer warps: each (halo row, 8-pixel run, 8-channel group)
    block of the channel-major staging becomes 8 pixel rows of the
    pixel-major tile, pixel row hy * pitch + 8 run + r."""
    rows, kc, pw = raw.shape
    tile = raw.new_full((rows * pw, kc), float("nan"))
    for hy in range(rows):
        for run in range(pw // 8):
            for g in range(kc // 8):
                block = raw[hy, 8 * g:8 * g + 8, 8 * run:8 * run + 8]
                p = hy * pw + 8 * run
                tile[p:p + 8, 8 * g:8 * g + 8] = block.t()
    return tile


def _halo_nhwc(x, c0, gy0, gx0, rows, pw):
    """The pixel-major tile as the NHWC tensor map's box (WGMMA_CHUNK
    channels, pw pixels, rows) lands from x (H, W, C): pixel row hy * pw +
    px."""
    win = _window(x.permute(2, 0, 1), c0, gy0, gx0, rows, pw)
    return win.permute(1, 2, 0).reshape(rows * pw, k3.WGMMA_CHUNK)


def _emulate(layout, x, w, b, mode, tile):
    th, tw, bn = k3.WGMMA_TILES[tile]
    kc = k3.WGMMA_CHUNK
    pw, left = k3.WGMMA_HALO[layout]
    if layout == k3.NCHW:
        B, C, H, W = x.shape
    else:
        B, H, W, C = x.shape
    packed = k3.pack_weights_reference(w, mode)  # (9, Coutp, Cp)
    Cout = {k3.PACK_OIHW: w.shape[0], k3.PACK_FLIP: w.shape[1],
            k3.PACK_HWIO: w.shape[3]}[mode]
    y = x.new_full((B, Cout, H, W), float("nan"))
    for bi in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                for n0 in range(0, Cout, bn):
                    acc = x.new_zeros(th, tw, bn)
                    for c0 in range(0, C, kc):
                        if layout == k3.NCHW:
                            a = _transpose(_halo_nchw(
                                x[bi], c0, y0 - 1, x0 - left, th + 2, pw))
                        else:
                            a = _halo_nhwc(x[bi], c0, y0 - 1, x0 - left,
                                           th + 2, pw)
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            # the weight box: zero past the packed array
                            wt = x.new_zeros(bn, kc)
                            part = packed[tap, n0:n0 + bn, c0:c0 + kc]
                            wt[:part.shape[0], :part.shape[1]] = part
                            for t in range(th):
                                row0 = (t + ky) * pw + left - 1 + kx
                                acc[t] += a[row0:row0 + tw] @ wt.t()
                    if b is not None:
                        bb = x.new_zeros(bn)
                        part = b[n0:n0 + bn]
                        bb[:part.shape[0]] = part.to(x.dtype)
                        acc = acc + bb
                    rows, cols = min(th, H - y0), min(tw, W - x0)
                    chans = min(bn, Cout - n0)
                    y[bi, n0:n0 + chans, y0:y0 + rows, x0:x0 + cols] = (
                        acc[:rows, :cols, :chans].permute(2, 0, 1))
    return y if layout == k3.NCHW else y.permute(0, 2, 3, 1)


# (B, C, Cout, H, W): two chunks with a ragged second one, Cout past one
# 128-channel block, a partial column tile; two column tiles, a partial
# row tile, Cout below a block; three chunks
EMULATED = [(1, 72, 130, 5, 24), (2, 16, 8, 3, 72), (1, 130, 40, 2, 8)]
KINDS = [("forward", k3.NCHW, k3.PACK_OIHW), ("dgrad", k3.NCHW, k3.PACK_FLIP),
         ("nhwc", k3.NHWC, k3.PACK_HWIO)]


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float32)


@pytest.mark.parametrize("tile", range(len(k3.WGMMA_TILES)))
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k[0])
@pytest.mark.parametrize("shape", EMULATED,
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_tiling_is_the_conv(shape, kind, tile):
    name, layout, mode = kind
    B, C, Cout, H, W = shape
    if name == "forward":
        x, w, b = (_rand((B, C, H, W), 1), _rand((Cout, C, 3, 3), 2),
                   _rand((Cout,), 3))
        want = k3.conv3x3_reference(x, w, b)
    elif name == "dgrad":
        # x is the output gradient (C channels) of a conv Cout -> C whose
        # weights w are (C, Cout, 3, 3); the result is its input gradient
        x, w, b = _rand((B, C, H, W), 4), _rand((C, Cout, 3, 3), 5), None
        want = k3.conv3x3_reference(x, k3.flipped_weights(w))
    else:
        x, w, b = (_rand((B, H, W, C), 6), _rand((3, 3, C, Cout), 7),
                   _rand((Cout,), 8))
        want = k3.conv3x3_nhwc_reference(x, w, b)
    got = _emulate(layout, x, w, b, mode, tile)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_named_kernel_needs_a_card_tensor():
    x, w = torch.zeros(1, 8, 4, 8), torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        k3.conv3x3_by("wgmma", x, w)
    with pytest.raises(ValueError, match="CUDA"):
        k3.conv3x3_nhwc_by("mma", x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0))
