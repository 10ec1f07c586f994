"""The d = 128 and d = 256 wgmma designs at D = d rounded up to 32 columns
(``attn_packed_kernel_wgmma128<D, M4, BIAS>``, D = 96 and 128, and
``attn_packed_kernel_wgmma256<D, M4, BIAS>``, D = 160..256, of
``csrc/fused_attention_wgmma128.cu`` and ``_wgmma256.cu``): kernels K1
and K2 in bfloat16 at d = 65..256 with d % 8 = 0, on the CPU.

- Their arithmetic emulated in torch: each head row read through a 4-d
  tensor map whose innermost extent is d (``attention_wgmma.cuh::
  encode4``), so the columns past d are zero in q, k and v (TMA's fill)
  and are not stored (TMA's clip, or the d = 256 design's column test);
  a head row as full 64-column parts and, where D % 64 = 32, one
  32-column part (the 64-byte swizzle); q.k summed over the parts in
  order, 64-key tiles, scores in log2 units, the running max from
  -FLT_MAX, exp2, p as bf16 hi + lo into each part of O, 0 for an
  all-masked row, one rounding. The d = 128 design's rows in items of
  128 (two warpgroups of 64) over persistent blocks, the d = 256
  design's in blocks of 64. Held against the JAX package's Pallas kernels
  in interpret mode and the plain versions, in both layouts, at one bf16
  ulp (``chip_smoke.py``'s bf16 tolerance), with ragged L and K, a shared
  codebook and a bias that masks batch row 0.
- ``plan``'s routing: bf16 at aligned pointers and d % 8 = 0 from 65 to
  256 on the two designs, d = 128 and 256 on their exact instantiations,
  257 to 512 on the d = 512 design; unaligned pointers, d % 8 != 0 and d
  above 512 on the d-chunked kernel.
- The designs' shared memory, stages and part offsets at every D, as the
  sources compute them.
- The 4-d maps' addressing (``layout_maps4``) in both layouts: a box at
  head h reads that head's d columns and nothing of the next head's.
- ``chip_attention_cols.py``'s SASS parsing and its pad-to-64 rewrite of
  the sources.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from test_torch_attention_f32wide import _split, _token_major  # noqa: E402
from test_torch_attention_wgmma import (  # noqa: E402
    BF16_TOL,
    FLT_MAX,
    H100_SMS,
    LOG2E,
    WG128_ROWS,
    WG128_WG_ROWS,
    WG_KEYS,
    wgmma128_items,
)
from test_torch_attention_widths import _inputs, _pallas  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401


def parts(D):
    """A head row's parts: full 64-column boxes, then a 32-column one
    where D % 64 = 32."""
    return [slice(c, min(c + 64, D)) for c in range(0, D, 64)]


def head_rows(t, b, h, d, D, rows):
    """What a 4-d map's boxes read of head h, batch row b (t (B, T, E) or a
    shared (T, E)): the head row's d columns, zero past d up to D."""
    x = (t if t.dim() == 2 else t[b])[rows, h * d:(h + 1) * d].float()
    return torch.nn.functional.pad(x, (0, D - d))


def emulate_cols(q, k, v, bias, num_heads, grid=H100_SMS):
    """The two wgmma designs on token-major bf16 inputs: q (B, L, E), k, v
    (B, K, E) or (K, E), bias (B, K) float32 or None; returns bf16 (B, L,
    E), every element written by exactly one warpgroup (NaN otherwise)."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    D = port.wgmma_cols(d)
    sl2 = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E
    out = torch.full((B, L, E), float("nan"), dtype=torch.bfloat16)
    if d <= 128:  # items of 128 rows, two warpgroups of 64
        blocks = wgmma128_items(B, H, L,
                                min(grid, -(-L // WG128_ROWS) * H * B))
        groups = [(q0 + w * WG128_WG_ROWS, h, b)
                  for items in blocks.values() for q0, h, b in items
                  for w in range(WG128_ROWS // WG128_WG_ROWS)]
    else:  # blocks of 64 rows
        groups = [(r0, h, b) for b in range(B) for h in range(H)
                  for r0 in range(0, L, 64)]
    for r0, h, b in groups:
        rows = slice(r0, min(r0 + 64, L))
        if r0 >= L:
            continue
        qh = head_rows(q, b, h, d, D, rows)
        kh = head_rows(k, b, h, d, D, slice(None))
        vh = head_rows(v, b, h, d, D, slice(None))
        R = qh.shape[0]
        m = torch.full((R,), -FLT_MAX)
        l = torch.zeros(R)
        acc = torch.zeros(R, D)
        for k0 in range(0, K, WG_KEYS):
            n = min(WG_KEYS, K - k0)
            kt = torch.zeros(WG_KEYS, D)  # TMA zero-fills past K
            vt = torch.zeros(WG_KEYS, D)
            kt[:n], vt[:n] = kh[k0:k0 + n], vh[k0:k0 + n]
            s = torch.zeros(R, WG_KEYS)
            for c in parts(D):  # q.k part by part, in order
                s = s + qh[:, c] @ kt[:, c].T
            if bias is not None:
                bl = torch.full((WG_KEYS,), -math.inf)
                bl[:n] = bias[b, k0:k0 + n] * LOG2E
                s = s * sl2 + bl
                mx = s.amax(-1)
            else:
                s[:, n:] = -math.inf
                mx = s.amax(-1) * sl2
            m_new = torch.maximum(m, mx)
            c_ = torch.exp2(m - m_new)
            m = m_new
            l, acc = l * c_, acc * c_[:, None]
            p = torch.exp2(s - m[:, None]) if bias is not None else \
                torch.exp2(s * sl2 - m[:, None])
            l = l + p.sum(-1)
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            for c in parts(D):
                acc[:, c] += hi @ vt[:, c] + lo @ vt[:, c]
        o = acc / l[:, None]
        if bias is not None:
            keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
            o = torch.where(keep[:, None], o, torch.zeros(()))
        # the store: d columns of this head (TMA's clip, or the column
        # test), rows past L never reached
        assert torch.isnan(out[b, rows, h * d:(h + 1) * d].float()).all()
        out[b, rows, h * d:(h + 1) * d] = o[:, :d].bfloat16()
    return out


COLS_CASES = [
    # d, H, B, L, K, bias, shared
    (72, 2, 2, 70, 130, True, False),   # D = 96: 24 zero columns, a tail
    (96, 2, 2, 40, 129, False, True),   # D = 96: an exact tail, shared
    (104, 1, 2, 130, 64, True, True),   # D = 128 on 4-d maps, two items
    (136, 2, 2, 33, 200, True, False),  # D = 160: two full parts + tail
    (192, 1, 3, 20, 65, False, False),  # D = 192: three full parts
    (224, 1, 2, 70, 100, True, True),   # D = 224, two blocks of rows
    (248, 2, 1, 17, 90, True, False),   # D = 256 on 4-d maps, clipped
]


@pytest.mark.parametrize("split", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("d,H,B,L,K,masked,shared", COLS_CASES, ids=str)
def test_wgmma_cols_emulation_matches_pallas_and_plain(d, H, B, L, K,
                                                       masked, shared,
                                                       split):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=d + K + L,
                            dtype=torch.bfloat16, split=split)
    want_kernel = "wgmma128" if d <= 128 else "wgmma256"
    assert port.plan(torch.bfloat16, B, H, L, d, H100_SMS, 0, 0, 0,
                     0).kernel == want_kernel
    got = emulate_cols(*(_token_major(q, k, v) if split else (q, k, v)),
                       bias, H, grid=3)
    assert not torch.isnan(got.float()).any(), "a row no warpgroup wrote"
    if split:
        got = _split(got, H)
    got = got.float()
    torch.testing.assert_close(got, _pallas(H, q, k, v, bias, split),
                               **BF16_TOL)
    plain = (port.fused_attention_reference(q, k, v, bias) if split else
             port.fused_attention_packed_reference(q, k, v, bias,
                                                   num_heads=H))
    torch.testing.assert_close(got, plain.float(), **BF16_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [65, 66, 72, 80, 96, 100, 104, 120, 127, 128,
                               129, 136, 160, 161, 168, 192, 200, 224, 248,
                               255, 256, 257, 264, 320, 512, 513, 520])
def test_plan_routes_bf16_widths(d):
    """bf16 above 64: at 16-byte aligned q, k, v and out and d % 8 = 0 the
    d = 128 design up to 128 (128 query rows an item) and the d = 256
    design up to 256 (64 rows a block), at D = d rounded up to 32, and the
    d = 512 design up to 512 (64 rows a block, two parts of W columns);
    off 16 bytes, at d % 8 != 0 or above 512 the d-chunked kernel."""
    aligned = port.plan(torch.bfloat16, 16, 2, 1024, d, H100_SMS, 4096,
                        4096, 4096, 4096)
    chunked = port.Plan("chunked", port.CHUNKED_ROWS[torch.bfloat16])
    if d % 8 == 0 and d <= 128:
        assert aligned == port.Plan("wgmma128", port.WGMMA128_ROWS)
    elif d % 8 == 0 and d <= 256:
        assert aligned == port.Plan("wgmma256", port.WGMMA_ROWS)
    elif d % 8 == 0 and d <= 512:
        assert aligned == port.Plan("wgmma512", port.WGMMA_ROWS)
    else:
        assert aligned == chunked
    for off in range(4):
        ptrs = [4096 + 8 * (i == off) for i in range(4)]
        assert port.plan(torch.bfloat16, 16, 2, 1024, d, H100_SMS,
                         *ptrs) == chunked, (d, off)
    if aligned.kernel == "wgmma512":
        W = port.wgmma512_part(d)
        assert W % 32 == 0 and d <= 2 * W < d + 64
        assert W in (160, 192, 224, 256)
    elif aligned != chunked:
        D = port.wgmma_cols(d)
        assert D % 32 == 0 and d <= D < d + 32
        assert D in ((96, 128) if d <= 128 else (160, 192, 224, 256))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # a block's shared memory on the H100


def wgmma128_smem(D):
    """fused_attention_wgmma128.cu's Geo<D>::kSmem: a 128-row query tile
    of 2D-byte rows, two warpgroups' 64-row output tiles, 4 stages of a
    64-key k and v tile and the stage's bias, 16 barriers, 1024 bytes to
    align the base."""
    return 128 * 2 * D + 2 * 64 * 2 * D + 4 * (2 * 64 * 2 * D + 256) \
        + (2 * 4 + 2 + 4) * 8 + 1024


def wgmma256_geometry(D):
    """fused_attention_wgmma256.cu's Geo<D>: the stages that fit beside a
    64-row query tile, and the shared memory."""
    q, stage = 64 * 2 * D, 2 * 64 * 2 * D
    stages = (SMEM_LIMIT - 1024 - q - 64) // (stage + 256 + 16)
    return stages, q + stages * (stage + 256) + (2 * stages + 1) * 8 + 1024


def test_wgmma128_design_fits_at_each_D():
    assert wgmma128_smem(128) == 198768  # the d = 128 kernel's, unchanged
    assert wgmma128_smem(96) <= SMEM_LIMIT


def test_wgmma256_design_stages_at_each_D():
    """3 stages at D = 256 (the d = 256 kernel's 225.8 KiB, unchanged) and
    224, 4 at 192, 5 at 160; every block fits, one an SM."""
    got = {D: wgmma256_geometry(D) for D in (160, 192, 224, 256)}
    assert {D: s for D, (s, _) in got.items()} == {160: 5, 192: 4, 224: 3,
                                                  256: 3}
    assert got[256][1] == 231224
    assert all(smem <= SMEM_LIMIT for _, smem in got.values())


@pytest.mark.parametrize("D", [96, 128, 160, 192, 224, 256])
def test_parts_start_at_swizzle_periods(D):
    """Every part of the q, k, v and output tiles starts at a multiple of
    1024 bytes (the 128-byte swizzle's period, and twice the 64-byte
    one's), so the consumers' swizzled addresses and the wgmma
    descriptors' zero base offset hold for the tail part too."""
    rows = 128 if D <= 128 else 64
    offsets = [c.start * 2 * r for c in parts(D) for r in (rows, 64)]
    tiles = [64 * 2 * D, 2 * 64 * 2 * D, rows * 2 * D]
    assert all(o % 1024 == 0 for o in offsets + tiles)
    assert [c.stop - c.start for c in parts(D)][-1] == (32 if D % 64 else 64)


# ---------------------------------------------------------------------------
# the 4-d maps' addressing
# ---------------------------------------------------------------------------

def maps4(layout, B, H, L, d, kv_shared=False, T=None):
    """attention_wgmma.cuh::layout_maps4 for one tensor of T rows (q's L
    by default): dims (d, heads, rows, planes), element strides of a head,
    a row and a plane, and the coordinates (col_h, z_b, z_h)."""
    T = T or L
    E = H * d
    if layout == 0:
        planes = 1 if kv_shared else B
        return ((d, H, T, planes), (d, E, E * T),
                (1, 0 if kv_shared else 1, 0))
    planes = H if kv_shared else B * H
    return ((d, 1, T, planes), (d, d, d * T), (0, 0 if kv_shared else H, 1))


def read_box(flat, dims, strides, coords, cols, rows):
    """A box of rows x cols at (c0, c1, row, plane): TMA's read, zero past
    each dim's extent."""
    box = torch.zeros(rows, cols)
    c0, c1, r0, z = coords
    for r in range(rows):
        for c in range(cols):
            at = (c0 + c, c1, r0 + r, z)
            if all(x < n for x, n in zip(at, dims)):
                box[r, c] = flat[at[0] + sum(
                    x * s for x, s in zip(at[1:], strides))]
    return box


@pytest.mark.parametrize("layout", [0, 1], ids=["token_major", "split"])
@pytest.mark.parametrize("kv_shared", [False, True], ids=["per_row",
                                                          "shared"])
def test_maps4_boxes_read_one_head_row(layout, kv_shared):
    """At d = 72 (D = 96: a 64-column box and a 32-column one), the boxes
    of head h read its columns 0..71 and zeros, never the next head's."""
    B, H, T, d = 2, 3, 5, 72
    n = 1 if kv_shared else B
    t = torch.arange(n * T * H * d, dtype=torch.float32).reshape(n, T, H * d)
    flat = (t if layout == 0 else
            t.reshape(n, T, H, d).permute(0, 2, 1, 3).contiguous()).flatten()
    dims, strides, (col_h, z_b, z_h) = maps4(layout, B, H, T, d, kv_shared)
    for b in range(B):
        for h in range(H):
            z = b * z_b + h * z_h
            got = torch.cat([read_box(flat, dims, strides,
                                      (c.start, h * col_h, 0, z),
                                      c.stop - c.start, T)
                             for c in parts(96)], dim=1)
            want = torch.nn.functional.pad(
                t[0 if kv_shared else b, :, h * d:(h + 1) * d], (0, 24))
            assert torch.equal(got, want), (b, h)


# ---------------------------------------------------------------------------
# chip_attention_cols.py
# ---------------------------------------------------------------------------

def test_cols_script_names_instances_across_trees():
    """The parent's <BIAS> kernels and this tree's 3-d-map <D, false,
    BIAS> instantiations at D = 128 and 256 get one name; the new widths'
    keep their own."""
    import chip_attention_cols as cols

    ns = "_ZN42_GLOBAL__N__abc_fused_attention_wgmma128_cu"
    assert cols.instance(f"{ns}27attn_packed_kernel_wgmma128ILb1EEEvS_") == \
        cols.instance(f"{ns}27attn_packed_kernel_wgmma128ILi128ELb0ELb1EEEvS")
    assert cols.instance(f"{ns}attn_packed_kernel_wgmma256ILi256ELb1ELb0EEEv"
                         ) == ("attn_packed_kernel_wgmma256",
                               "Li256ELb1ELb0E")
    assert cols.instance(f"{ns}attn_packed_kernel_wgmmaILi32ELb0EEEv") == (
        "attn_packed_kernel_wgmma", "Li32ELb0E")
    sass = """
        Function : _Zkern
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x000 */
                                                            /* 0x001 */
        /*0010*/                   @!P1 BRA 0x360 ;        /* 0x002 */
    """
    assert cols.functions(sass) == {"_Zkern": ["LDC R1, c[0x0][0x28]",
                                               "@!P1 BRA 0x360"]}


def test_cols_script_rewrites_the_sources_rounding():
    """Each pad-to-64 rewrite matches the source once, so the script
    builds what it names."""
    import chip_attention_cols as cols
    from synergize_motion_appearance_tpu_torch.ops import cuda_build

    for lib, old, new in cols.PAD64:
        src = (cuda_build.CSRC / f"{lib}.cu").read_text()
        assert src.count(old) == 1 and old != new
    assert [port.wgmma_cols(E // H) for E, H in cols.PAD64_WIDTHS] == [
        96, 160]
