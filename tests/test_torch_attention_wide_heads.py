"""Attention at wide heads: kernels K1 and K2 in bfloat16 at d = 257..512
with d % 8 = 0 (``attn_packed_kernel_wgmma512<W, BIAS>`` of
``csrc/fused_attention_wgmma512.cu``), on the CPU; float32 at d =
513..1024 (``attn_packed_kernel_f32wide<C>`` at C = 640..1024) is
emulated in ``test_torch_attention_f32wide``.

- The d = 512 wgmma design's arithmetic emulated in torch: a head row's
  output columns in two parts of W = d rounded up to 64, halved, each a
  block of 64 query rows that runs the whole q.k (two depth halves of W
  columns, each as 64-column boxes and, where W % 64 = 32, one 32-column
  box, zero past d as a 4-d map's box reads them) and every exponential,
  64-key tiles, scores in log2 units, the running max from -FLT_MAX,
  exp2, p as bf16 hi + lo into its part's W columns of O, 0 for an
  all-masked row, one rounding, no store past d. Held against the JAX
  package's Pallas kernels in interpret mode and the plain versions, in
  both layouts, at one bf16 ulp (``chip_smoke.py``'s bf16 tolerance).
- The d = 512 design's geometry as the source computes it: the ring's
  slots and shared memory at each W, every box at a swizzle period, the
  fragments' cover of rows, keys and columns, the two parts' stores, and
  the order in which the producer fills and the consumer waits for and
  releases the ring's units (no wait on a unit that cannot come).
- ``plan`` at the new boundaries: bf16 256 / 257 / 264, 512 / 513 / 520;
  float32 512 / 513, 1024 / 1025.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from test_torch_attention_f32wide import (  # noqa: E402
    _split,
    _token_major,
    wide_geometry,
)
from test_torch_attention_wgmma import (  # noqa: E402
    BF16_TOL,
    FLT_MAX,
    H100_SMS,
    LOG2E,
    WG_KEYS,
)
from test_torch_attention_wgmma_cols import (  # noqa: E402
    SMEM_LIMIT,
    head_rows,
    parts,
)
from test_torch_attention_widths import _inputs, _pallas  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

ROWS = 64  # query rows of a block of the d = 512 design


def part_width(d):
    """W: d rounded up to 64, halved."""
    return -(-d // 64) * 32


def emulate_wgmma512(q, k, v, bias, num_heads):
    """The d = 512 wgmma design on token-major bf16 inputs: q (B, L, E), k,
    v (B, K, E) or (K, E), bias (B, K) float32 or None; returns bf16 (B, L,
    E), every element written by exactly one block (NaN otherwise)."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    W = part_width(d)
    D = 2 * W
    sl2 = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E
    out = torch.full((B, L, E), float("nan"), dtype=torch.bfloat16)
    for b in range(B):
        for h in range(H):
            kh = head_rows(k, b, h, d, D, slice(None))
            vh = head_rows(v, b, h, d, D, slice(None))
            for r0 in range(0, L, ROWS):
                rows = slice(r0, min(r0 + ROWS, L))
                qh = head_rows(q, b, h, d, D, rows)
                for part in range(2):  # two blocks, W columns each
                    o, m = _block(qh, kh, vh, None if bias is None else
                                  bias[b], K, W, part, sl2)
                    c0 = part * W
                    n = min(W, d - c0)  # no store past d
                    cols = slice(h * d + c0, h * d + c0 + n)
                    assert torch.isnan(out[b, rows, cols].float()).all()
                    out[b, rows, cols] = o[:, :n].bfloat16()
    return out


def _block(qh, kh, vh, bias, K, W, part, sl2):
    """One block: the whole q.k over both depth halves, the online softmax
    and p.v into part ``part``'s W columns; returns (O / sum, max)."""
    R = qh.shape[0]
    m = torch.full((R,), -FLT_MAX)
    l = torch.zeros(R)
    acc = torch.zeros(R, W)
    for k0 in range(0, K, WG_KEYS):
        n = min(WG_KEYS, K - k0)
        kt = torch.zeros(WG_KEYS, 2 * W)  # TMA zero-fills past K
        vt = torch.zeros(WG_KEYS, 2 * W)
        kt[:n], vt[:n] = kh[k0:k0 + n], vh[k0:k0 + n]
        s = torch.zeros(R, WG_KEYS)
        for half in range(2):  # q.k: two depth halves, box by box
            for c in parts(W):
                cols = slice(half * W + c.start, half * W + c.stop)
                s = s + qh[:, cols] @ kt[:, cols].T
        if bias is not None:
            bl = torch.full((WG_KEYS,), -math.inf)
            bl[:n] = bias[k0:k0 + n] * LOG2E
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
        for c in parts(W):  # p.v into this part's boxes
            cols = slice(part * W + c.start, part * W + c.stop)
            acc[:, c] += hi @ vt[:, cols] + lo @ vt[:, cols]
    o = acc / l[:, None]
    if bias is not None:
        keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
        o = torch.where(keep[:, None], o, torch.zeros(()))
    return o, m


WGMMA512_CASES = [
    # d, H, B, L, K, bias, shared
    (264, 1, 2, 70, 130, True, False),  # W = 160; a 32-column box past d
    (288, 2, 1, 40, 129, False, True),  # W = 160, shared codebook, no bias
    (320, 1, 2, 65, 100, True, True),   # W = 160, d = 2W, two row blocks
    (384, 1, 2, 33, 70, True, False),   # W = 192
    (448, 1, 1, 20, 65, True, True),    # W = 224: a 32-column box a unit
    (512, 1, 2, 17, 90, True, True),    # W = 256 on a shared codebook
]


@pytest.mark.parametrize("split", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("d,H,B,L,K,masked,shared", WGMMA512_CASES, ids=str)
def test_wgmma512_emulation_matches_pallas_and_plain(d, H, B, L, K, masked,
                                                     shared, split):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=d + K + L,
                            dtype=torch.bfloat16, split=split)
    assert port.plan(torch.bfloat16, B, H, L, d, H100_SMS, 0, 0, 0,
                     0) == port.Plan("wgmma512", ROWS)
    got = emulate_wgmma512(*(_token_major(q, k, v) if split else (q, k, v)),
                           bias, H)
    assert not torch.isnan(got.float()).any(), "an element no block wrote"
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
# the d = 512 design's geometry
# ---------------------------------------------------------------------------

def wgmma512_geometry(W):
    """fused_attention_wgmma512.cu's Geo<W>: the slots of 64 rows x W
    columns that fit beside q's two depth halves, and the shared memory
    (the slots' bias, full and empty barriers, q's, the base's
    alignment)."""
    unit = 64 * 2 * W
    slots = (SMEM_LIMIT - 1024 - 2 * unit - 8) // (unit + 256 + 16)
    return slots, 2 * unit + slots * (unit + 256) + (2 * slots + 1) * 8 \
        + 1024


def test_wgmma512_slots_and_shared_memory_at_each_W():
    """5 slots at W = 256, 6 at 224, 7 at 192, 9 at 160 (the header note's
    counts); every block fits, one an SM; W from d."""
    got = {W: wgmma512_geometry(W) for W in (160, 192, 224, 256)}
    assert {W: s for W, (s, _) in got.items()} == {160: 9, 192: 7, 224: 6,
                                                  256: 5}
    assert all(smem <= SMEM_LIMIT for _, smem in got.values())
    assert got[256][1] == 231768
    for d in (257, 264, 320, 328, 384, 392, 448, 456, 512):
        assert port.wgmma512_part(d) == part_width(d) == \
            -(-d // 64) * 64 // 2
        assert 2 * part_width(d) - d < 64


@pytest.mark.parametrize("W", [160, 192, 224, 256])
def test_wgmma512_boxes_start_on_swizzle_periods(W):
    """q's halves and every slot are units of 64 rows x W columns; each
    unit's boxes (64 columns: the 128-byte swizzle, period 1024 bytes; 32
    columns: the 64-byte one, period 512) start at a multiple of 1024
    bytes of the 1024-aligned base, and each box's first column is a
    16-byte multiple of the head row (TMA's rule for a box start)."""
    slots, _ = wgmma512_geometry(W)
    unit = 64 * 2 * W
    units = [h * unit for h in range(2)] + [
        2 * unit + s * unit for s in range(slots)]
    starts = [u + c.start * 2 * 64 for u in units for c in parts(W)]
    assert all(a % 1024 == 0 for a in starts)
    assert [c.stop - c.start for c in parts(W)][-1] == (32 if W % 64 else 64)
    for half in range(2):  # columns of q's and k's boxes, and v's parts
        for c in parts(W):
            assert (2 * (half * W + c.start)) % 16 == 0


@pytest.mark.parametrize("d", [264, 288, 384, 448, 504, 512])
def test_wgmma512_fragments_cover_rows_keys_and_columns_once(d):
    """A consumer warpgroup's 128 threads hold rows 16 w + g and + 8 (warp
    w, g = lane / 4) and columns 8 j + 2 (lane % 4) and + 1 of each n8
    tile: every (row, key) of a 64 x 64 score tile and every (row,
    column) of a part's 64 x W O once; the two parts' stores write each of
    the head's d columns once and none past d."""
    W = part_width(d)
    scores, outs, stored = [], [], []
    for tid in range(128):
        w, lane = tid // 32, tid % 32
        rows = [16 * w + lane // 4 + 8 * r for r in range(2)]
        scores += [(r, 8 * j + 2 * (lane % 4) + e) for r in rows
                   for j in range(WG_KEYS // 8) for e in range(2)]
        outs += [(r, 8 * j + 2 * (lane % 4) + e) for r in rows
                 for j in range(W // 8) for e in range(2)]
        for part in range(2):
            c0 = part * W
            stored += [(r, c0 + 8 * j + 2 * (lane % 4) + e) for r in rows
                       for j in range(W // 8) if c0 + 8 * j < d
                       for e in range(2)]
    assert sorted(scores) == [(r, c) for r in range(64)
                              for c in range(WG_KEYS)]
    assert sorted(outs) == [(r, c) for r in range(64) for c in range(W)]
    assert sorted(stored) == [(r, c) for r in range(64) for c in range(d)]


def ring_schedule(ntiles):
    """The consumer's waits and releases of the ring's units in the
    kernel's order: unit u is tile u // 3's k depth half (u % 3 = 0, 1) or
    v part (u % 3 = 2). Tile 0 waits for its two k units and releases
    them (the second after q.k, the first after the softmax read its
    bias); tile t > 0 waits for its k units and tile t - 1's v, releases
    its second k unit, its first, then that v; the last v is waited for
    and never released."""
    ops = [("wait", 0), ("wait", 1), ("release", 1), ("release", 0)]
    for t in range(1, ntiles):
        u = 3 * t
        ops += [("wait", u), ("wait", u + 1), ("wait", u - 1),
                ("release", u + 1), ("release", u), ("release", u - 1)]
    return ops + [("wait", 3 * ntiles - 1)]


@pytest.mark.parametrize("W", [160, 192, 224, 256])
def test_wgmma512_ring_never_waits_on_a_unit_that_cannot_come(W):
    """The producer fills unit u into slot u % S once unit u - S has been
    released; the consumer's waits, run against it, always find their unit
    issued and not yet overwritten, at every tile count, and every unit
    but the last is released once."""
    S, _ = wgmma512_geometry(W)
    for ntiles in range(1, 8):
        released, issued, resident = set(), 0, {}
        for op, u in ring_schedule(ntiles):
            # the producer runs ahead as far as the releases let it
            while issued < 3 * ntiles and (issued < S or
                                           issued - S in released):
                resident[issued % S] = issued
                issued += 1
            if op == "wait":
                assert u < issued, (W, ntiles, u)
                assert resident[u % S] == u, (W, ntiles, u)
            else:
                assert u not in released
                released.add(u)
        assert issued == 3 * ntiles
        assert released == set(range(3 * ntiles - 1))


# ---------------------------------------------------------------------------
# plan at the new boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (dtype, d) -> kernel at aligned pointers
    ((torch.bfloat16, 256), "wgmma256"),
    ((torch.bfloat16, 257), "chunked"),  # d % 8 != 0
    ((torch.bfloat16, 264), "wgmma512"),
    ((torch.bfloat16, 512), "wgmma512"),
    ((torch.bfloat16, 513), "chunked"),
    ((torch.bfloat16, 520), "chunked"),  # above 512
    ((torch.float32, 512), "f32wide"),
    ((torch.float32, 513), "f32wide"),
    ((torch.float32, 1024), "f32wide"),
    ((torch.float32, 1025), "chunked"),
], ids=str)
def test_plan_at_the_wide_boundaries(case):
    (dtype, d), want = case
    got = port.plan(dtype, 16, 1, 1024, d, H100_SMS, 4096, 4096, 4096, 4096)
    assert got.kernel == want
    if want == "wgmma512":
        assert got == port.Plan("wgmma512", 64)
        # off 16 bytes: the d-chunked kernel
        assert port.plan(dtype, 16, 1, 1024, d, H100_SMS, 4096, 4104, 4096,
                         4096).kernel == "chunked"
    if want == "f32wide":
        assert got.rows == (32 if d <= 768 else 16)


def test_chip_smoke_runs_the_new_kernels_on_frame_batches():
    """chip_smoke's appearance d = 384 frame batch (n_head 1, E 384) runs
    its 16 appearance launches on the d = 512 wgmma design, and the tiny
    float32 variant at appearance d = 640 on the wide kernel at C = 640."""
    assert chip_smoke.head_width_kernels(torch, port, 1, H100_SMS,
                                         E_app=384) == {"f32": 16,
                                                        "wgmma512": 16}
    g = chip_smoke.HEAD_WIDTHS["app_d384"]["g"]
    assert (g["n_head"], g["embed_dim_app"], g["dim_embd_app"]) == (1, 384,
                                                                   384)
    g = chip_smoke.HEAD_WIDTHS["tiny_d640"]["g"]
    assert g["dim_embd_app"] // g["n_head"] == 640
    assert port.plan(torch.float32, 4, 1, 64, 640, H100_SMS, 0, 0, 0,
                     0) == port.Plan("f32wide", 32)
    assert wide_geometry(640)["R"] == 32
