"""Arithmetic of K1's two kernels on the main path, emulated in plain torch
on the CPU, and the plan that picks a call's kernel.

- ``attn_packed_kernel_wgmma`` (``csrc/fused_attention_wgmma.cu``, bfloat16
  at d = 16, 32 and 64; the appearance transformer's d = 32): keys in tiles
  of 64, keys past K scored -inf; with a bias, scores in log2 units as
  q.k * scale * log2(e) + bias * log2(e) and the running max over those;
  without one, the running max over q.k times scale * log2(e), the
  exponent's argument q.k * scale * log2(e) - max in one FMA; a running
  max from -FLT_MAX per row; exp2; p split into bf16 hi + lo, both
  multiplied by the bf16 values into a float32 accumulator that is
  rescaled before each tile's p.v; the row sum in float32; a row whose max
  is <= -1e29 (in log2 units) outputs 0; one rounding to bf16. Held
  against the JAX package's Pallas kernel in interpret mode and the port's
  plain version at ``chip_smoke.py``'s bf16 tolerance (atol 1e-3, rtol
  2^-7: each side rounds a float32 result once to bf16).
- ``attn_packed_kernel<DMAX, R>`` (``csrc/fused_attention_packed.cu``,
  float32; the motion transformer's d = 4): R query rows per thread, keys
  in tiles of 64 and chunks of 16, scores in log2 units (q taken times
  scale * log2(e), each dot product started from the staged bias times
  log2(e), -inf past K), the running max rescaling once per chunk, the
  exponent's argument score - max, the row sum in float32. Held against the
  Pallas kernel and the plain version at 2e-5, ``chip_smoke.py``'s float32
  tolerance.

- ``attn_packed_kernel_wgmma256`` (``csrc/fused_attention_wgmma256.cu``,
  bfloat16 at d = 256; the appearance transformer at n_head 1): the same
  arithmetic with a head row as four 64-column parts (q.k summed over the
  parts, p.v into each part of O), 64-key tiles; held against the Pallas
  kernel and the plain version at the bf16 tolerance; its shared memory
  and blocks an SM.
- ``attn_packed_kernel_wgmma128`` (``csrc/fused_attention_wgmma128.cu``,
  bfloat16 at d = 128; the appearance transformer at n_head 2): persistent
  blocks that walk items of 128 query rows of one head and batch row, each
  item's rows as two consumer warpgroups' 64, each through the same
  arithmetic with a head row as two 64-column parts and 64-key tiles; held
  against the Pallas kernel and the plain version at the bf16 tolerance;
  the items' cover of every row, its shared memory, threads, register
  split and blocks an SM.

The tiny config's widths (d = 2 and 8) run the mma.sync kernel in bf16,
whose emulation is ``test_torch_attention_tc.py``'s; here the plan test
holds that choice. Nothing here decides anything about a card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from synergize_motion_appearance_tpu.ops.fused_attention import (  # noqa: E402
    _fused_attention_packed_pallas,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401

BF16_TOL = dict(atol=1e-3, rtol=2 ** -7)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
FLT_MAX = torch.finfo(torch.float32).max
H100_SMS = 132
WG_KEYS = 64                     # keys per stage of the wgmma kernel
F32_KEYS, F32_CHUNK, F32_THREADS = 64, 16, 128  # the float32 kernel's


def _heads(t, B, H, K, d):
    """(B, K, E) or a shared (K, E) as (B, H, K, d), in float32."""
    return t.float().reshape(-1, K, H, d).permute(0, 2, 1, 3).expand(
        B, H, K, d)


def _scale_log2(d):
    return torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E


def _finish(acc, den, m, bias, B, L, E, dtype):
    out = acc / den[..., None]
    if bias is not None:
        keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
        out = torch.where(keep[..., None], out, torch.zeros(()))
    return out.permute(0, 2, 1, 3).reshape(B, L, E).to(dtype)


def emulate_wgmma(q, k, v, bias, num_heads, keys=WG_KEYS, cols=None):
    """The wgmma kernels' arithmetic on token-major bf16 inputs: q (B, L,
    E), k, v (B, K, E) or (K, E), bias (B, K) float32 or None; returns
    bf16 (B, L, E). keys: keys a tile; cols: columns of a part (a TMA box)
    where a head row is several, as at d = 256 (four of 64): q.k sums the
    parts' products, p.v adds into each part's columns of O."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    parts = [slice(c, c + (cols or d)) for c in range(0, d, cols or d)]
    qh = _heads(q, B, H, L, d)
    kh, vh = _heads(k, B, H, K, d), _heads(v, B, H, K, d)
    sl2 = _scale_log2(d)
    m = torch.full((B, H, L), -FLT_MAX)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, d)
    for k0 in range(0, K, keys):
        n = min(keys, K - k0)
        kt = torch.zeros(B, H, keys, d)   # TMA zero-fills past K
        vt = torch.zeros(B, H, keys, d)
        kt[:, :, :n] = kh[:, :, k0:k0 + n]
        vt[:, :, :n] = vh[:, :, k0:k0 + n]
        s = sum(qh[..., c] @ kt[..., c].transpose(-1, -2) for c in parts)
        if bias is not None:
            bl = torch.full((B, keys), -math.inf)
            bl[:, :n] = bias[:, k0:k0 + n] * LOG2E
            s = s * sl2 + bl[:, None, None, :]
            mx = s.amax(-1)
        else:
            s[..., n:] = -math.inf
            mx = s.amax(-1) * sl2
        m_new = torch.maximum(m, mx)
        c = torch.exp2(m - m_new)
        m = m_new
        l, acc = l * c, acc * c[..., None]
        p = torch.exp2(s - m[..., None]) if bias is not None else \
            torch.exp2(s * sl2 - m[..., None])
        l = l + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        for c in parts:
            acc[..., c] += hi @ vt[..., c] + lo @ vt[..., c]
    return _finish(acc, l, m, bias, B, L, E, torch.bfloat16)


def f32_thread_rows(L, R):
    """The query rows each thread of the float32 kernel owns, by (block,
    thread): rows block * R * 128 + i * 128 + thread for i < R, those < L."""
    blocks = -(-L // (R * F32_THREADS))
    return {(blk, t): [r for r in (blk * R * F32_THREADS + i * F32_THREADS
                                   + t for i in range(R)) if r < L]
            for blk in range(blocks) for t in range(F32_THREADS)}


def emulate_f32(q, k, v, bias, num_heads):
    """The float32 kernel's arithmetic per row (R rows a thread share the
    staged tile and change no row's arithmetic): float32 q (B, L, E), k, v
    (B, K, E) or (K, E), bias (B, K) or None; returns float32 (B, L, E)."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    qh = _heads(q, B, H, L, d)
    kh, vh = _heads(k, B, H, K, d), _heads(v, B, H, K, d)
    sl2 = _scale_log2(d)
    qh = qh * sl2
    m = torch.full((B, H, L), -FLT_MAX)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, d)
    for k0 in range(0, K, F32_KEYS):
        n = min(F32_KEYS, K - k0)
        pad = -(-n // F32_CHUNK) * F32_CHUNK
        kt = torch.zeros(B, H, pad, d)
        vt = torch.zeros(B, H, pad, d)
        kt[:, :, :n] = kh[:, :, k0:k0 + n]
        vt[:, :, :n] = vh[:, :, k0:k0 + n]
        bs = torch.full((B, pad), -math.inf)
        bs[:, :n] = 0.0 if bias is None else bias[:, k0:k0 + n] * LOG2E
        s = bs[:, None, None, :] + qh @ kt.transpose(-1, -2)
        for j0 in range(0, pad, F32_CHUNK):
            sc = s[..., j0:j0 + F32_CHUNK]
            m_new = torch.maximum(m, sc.amax(-1))
            c = torch.exp2(m - m_new)
            m = m_new
            l, acc = l * c, acc * c[..., None]
            p = torch.exp2(sc - m[..., None])
            l = l + p.sum(-1)
            acc = acc + p @ vt[:, :, j0:j0 + F32_CHUNK]
    return _finish(acc, l, m, bias, B, L, E, torch.float32)


def _inputs(B, L, K, E, masked, shared, seed, dtype=torch.bfloat16):
    """q, k, v (times 2, so the softmax is not flat) in ``dtype`` and a
    float32 bias masking 30% of the keys and every key of batch row 0."""
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.from_numpy(2 * rng.randn(*shape).astype(
            np.float32)).to(dtype)

    q = randn(B, L, E)
    kshape = (K, E) if shared else (B, K, E)
    k, v = randn(*kshape), randn(*kshape)
    bias = None
    if masked:
        drop = rng.rand(B, K) < 0.3
        drop[0] = True
        bias = torch.from_numpy(np.where(drop, -1e30, 0.0).astype(
            np.float32))
    return q, k, v, bias


def _pallas(H, q, k, v, bias):
    def j(t):
        return None if t is None else jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    out = _fused_attention_packed_pallas(H, j(q), j(k), j(v), j(bias),
                                         interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


WGMMA_CASES = [
    # B, H, L, K, E, bias, shared
    (1, 8, 24, 130, 256, False, True),    # d = 32 (appearance), 3 tiles
    (2, 8, 40, 300, 256, True, False),    # d = 32, bias, ragged K, 5 tiles
    (2, 8, 70, 128, 256, False, False),   # d = 32, two full tiles, L > 64
    (3, 4, 20, 90, 64, True, True),       # d = 16, shared codebook, bias
    (2, 2, 16, 257, 32, False, False),    # d = 16, a one-key last tile
    (2, 2, 16, 200, 128, True, False),    # d = 64, bias
    (1, 4, 33, 40, 256, False, True),     # d = 64, shared, one short tile
]


@pytest.mark.parametrize("B,H,L,K,E,masked,shared", WGMMA_CASES, ids=str)
def test_wgmma_emulation_matches_pallas_and_plain(B, H, L, K, E, masked,
                                                  shared):
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=L + K + E)
    assert port.plan(q.dtype, B, H, L, E // H, H100_SMS, 0, 0, 0,
                     0).kernel == "wgmma"
    got = emulate_wgmma(q, k, v, bias, H).float()
    want = _pallas(H, q, k, v, bias)
    torch.testing.assert_close(got, want, **BF16_TOL)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H).float()
    torch.testing.assert_close(got, plain, **BF16_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
        assert want[0].abs().max().item() == 0.0
    assert torch.isfinite(got).all()


WGMMA256_CASES = [
    # B, H, L, K, E, bias, shared
    (2, 1, 70, 100, 256, True, False),    # L off the 64-row query tile
    (2, 1, 24, 129, 256, False, False),   # a one-key last tile
    (3, 1, 20, 129, 256, True, True),     # shared codebook, bias, one key
    (1, 2, 16, 40, 512, False, True),     # two heads, shared, one tile
    (2, 1, 8, 256, 256, True, True),      # whole tiles past the 3-stage ring
    (1, 1, 1, 64, 256, False, False),     # one query row, one whole tile
]


@pytest.mark.parametrize("B,H,L,K,E,masked,shared", WGMMA256_CASES, ids=str)
def test_wgmma256_emulation_matches_pallas_and_plain(B, H, L, K, E, masked,
                                                     shared):
    """The d = 256 kernel's blocking: 64-key tiles, a head row as four
    64-column parts, scores in log2 units, p.v as hi + lo into each part
    of O; against the Pallas kernel and the plain version at d = 256, the
    all-masked batch row 0 exactly 0."""
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=L + K + E)
    assert port.plan(q.dtype, B, H, L, E // H, H100_SMS, 0, 0, 0,
                     0).kernel == "wgmma256"
    got = emulate_wgmma(q, k, v, bias, H, keys=WG_KEYS, cols=64).float()
    want = _pallas(H, q, k, v, bias)
    torch.testing.assert_close(got, want, **BF16_TOL)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H).float()
    torch.testing.assert_close(got, plain, **BF16_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
        assert want[0].abs().max().item() == 0.0
    assert torch.isfinite(got).all()


def wgmma256_geometry():
    """Threads, shared memory (bytes) and blocks an SM of the d = 256
    kernel, as csrc/fused_attention_wgmma256.cu computes them: a 64-row
    query tile of 4 parts of 64 x 128 bytes; 3 stages, each a k and a v
    tile of 64 keys (4 parts each) and the stage's bias; 2 barriers a
    stage and one for q; 1024 bytes to align the base; one consumer
    warpgroup and one producer warp; 1 KiB a block reserved by the card
    out of an SM's 233,472 bytes."""
    q = 4 * 64 * 128
    tile = 4 * 64 * 128
    stages = 3
    smem = q + stages * (2 * tile + 64 * 4) + (2 * stages + 1) * 8 + 1024
    return 128 + 32, smem, 233472 // (smem + 1024)


def test_wgmma256_geometry():
    """The block fits a block's 232,448 bytes of shared memory, at the 160
    threads, one block an SM and 64 query rows a block that the header
    note and plan state."""
    threads, smem, blocks = wgmma256_geometry()
    assert smem == 231224 <= 232448
    assert (threads, blocks) == (160, 1)
    assert port.plan(torch.bfloat16, 16, 1, 1024, 256, H100_SMS, 0, 0, 0,
                     0) == port.Plan("wgmma256", 64)


WG128_ROWS, WG128_WG_ROWS = 128, 64  # query rows of an item, a warpgroup's


def wgmma128_items(B, H, L, grid):
    """The items of the d = 128 kernel's persistent blocks, as its Item
    decodes them: item i is (query tile i % nq, head i / nq % H, batch row
    i / (nq H)), block blk takes items blk, blk + grid, ...; returns
    {block: [(q0, h, b), ...]}."""
    nq = -(-L // WG128_ROWS)
    items = nq * H * B
    return {blk: [(i % nq * WG128_ROWS, i // nq % H, i // nq // H)
                  for i in range(blk, items, grid)] for blk in range(grid)}


def emulate_wgmma128(q, k, v, bias, num_heads, grid=H100_SMS):
    """The d = 128 kernel on token-major bf16 inputs: each block's items in
    turn, each item's 128 rows as two consumer warpgroups' 64 (rows past L
    dropped), each warpgroup's rows of its head through emulate_wgmma's
    arithmetic with two 64-column parts and 64-key tiles."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    items = wgmma128_items(B, H, L, min(grid, -(-L // WG128_ROWS) * H * B))
    out = torch.full((B, L, E), float("nan"), dtype=torch.bfloat16)
    for blk_items in items.values():
        for q0, h, b in blk_items:
            cols = slice(h * d, (h + 1) * d)
            kb = k[..., cols] if k.dim() == 2 else k[b:b + 1, :, cols]
            vb = v[..., cols] if v.dim() == 2 else v[b:b + 1, :, cols]
            bb = None if bias is None else bias[b:b + 1]
            for w in range(WG128_ROWS // WG128_WG_ROWS):
                r0 = q0 + w * WG128_WG_ROWS
                r1 = min(r0 + WG128_WG_ROWS, L)
                if r0 < r1:
                    out[b, r0:r1, cols] = emulate_wgmma(
                        q[b:b + 1, r0:r1, cols], kb, vb, bb, 1, keys=WG_KEYS,
                        cols=64)[0]
    return out


WGMMA128_CASES = [
    # B, H, L, K, E, bias, shared
    (2, 2, 200, 300, 256, True, False),   # two items a head, ragged K, bias
    (2, 2, 130, 129, 256, False, True),   # shared, a one-key last tile
    (3, 2, 1000, 333, 256, True, True),   # ragged L and K, shared, bias
    (2, 2, 1, 64, 256, True, False),      # one query row, one whole tile
    (1, 2, 64, 64, 256, False, False),    # rows of warpgroup 0 only
    (2, 1, 70, 200, 128, True, True),     # one head, shared, bias
]


@pytest.mark.parametrize("B,H,L,K,E,masked,shared", WGMMA128_CASES, ids=str)
def test_wgmma128_emulation_matches_pallas_and_plain(B, H, L, K, E, masked,
                                                     shared):
    """The d = 128 kernel's blocking (items of 128 rows in two warpgroups
    of 64, 64-key tiles, a head row as two 64-column parts, scores in log2
    units, p.v as hi + lo into each part of O), on blocks that take several
    items each (a grid of 3) and on one item a block: against the Pallas
    kernel and the plain version at d = 128, the all-masked batch row 0
    exactly 0."""
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=L + K + E)
    assert port.plan(q.dtype, B, H, L, E // H, H100_SMS, 0, 0, 0,
                     0) == port.Plan("wgmma128", WG128_ROWS)
    got = emulate_wgmma128(q, k, v, bias, H, grid=3).float()
    assert torch.equal(got, emulate_wgmma128(q, k, v, bias, H).float())
    want = _pallas(H, q, k, v, bias)
    torch.testing.assert_close(got, want, **BF16_TOL)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H).float()
    torch.testing.assert_close(got, plain, **BF16_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
        assert want[0].abs().max().item() == 0.0
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("B,H,L", [(16, 2, 1024), (2, 2, 1024), (3, 2, 1000),
                                   (1, 1, 1), (5, 3, 129)], ids=str)
@pytest.mark.parametrize("grid", [H100_SMS, 7, 1])
def test_wgmma128_items_cover_each_row_once(B, H, L, grid):
    """Every (batch row, head, query row) is in exactly one warpgroup of one
    item of one block, at the card's grid (a frame batch: 256 items on 132
    blocks; the train step's B = 2: 32 items) and at fewer blocks."""
    seen = []
    for blk_items in wgmma128_items(B, H, L, grid).values():
        for q0, h, b in blk_items:
            seen += [(b, h, r) for r in range(q0, min(q0 + WG128_ROWS, L))]
    assert sorted(seen) == [(b, h, r) for b in range(B) for h in range(H)
                            for r in range(L)]


def wgmma128_geometry():
    """Threads, shared memory (bytes), blocks an SM and the register split
    of the d = 128 kernel, as csrc/fused_attention_wgmma128.cu computes
    them: a 128-row query tile of 2 parts of 128 x 128 bytes; two consumer
    warpgroups' output tiles of 2 parts of 64 x 128 bytes; 4 stages, each a
    k and a v tile of 64 keys (2 parts each) and the stage's bias; 2
    barriers a stage, q's 2 and 2 an output tile; 1024 bytes to align the
    base; 1 KiB a block reserved by the card out of an SM's 233,472 bytes;
    two consumer warpgroups at 232 registers a thread and a producer
    warpgroup at 40, out of the 168 a thread the launch bound gives."""
    q = 2 * 128 * 128
    outs = 2 * 2 * 64 * 128
    stages = 4
    smem = (q + outs + stages * (2 * 2 * 64 * 128 + 64 * 4)
            + (2 * stages + 2 + 2 * 2) * 8 + 1024)
    threads = 3 * 128
    regs = 128 * (2 * 232 + 40)
    return threads, smem, 233472 // (smem + 1024), regs


def test_wgmma128_geometry():
    """The block fits a block's 232,448 bytes of shared memory and the SM's
    registers, at the 384 threads, one block an SM and 128 query rows an
    item that the header note and plan state."""
    threads, smem, blocks, regs = wgmma128_geometry()
    assert smem == 198768 <= 232448
    assert blocks * (smem + 1024) <= 233472
    assert (threads, blocks) == (384, 1)
    assert regs <= threads * (65536 // threads // 8 * 8) == 384 * 168
    assert port.plan(torch.bfloat16, 16, 2, 1024, 128, H100_SMS, 0, 0, 0,
                     0) == port.Plan("wgmma128", 128)


F32_CASES = [
    # B, H, L, K, E, bias, shared
    (2, 8, 24, 100, 32, False, False),    # d = 4 (motion), ragged K
    (2, 8, 40, 70, 32, True, True),       # d = 4, shared codebook, bias
    (3, 4, 16, 130, 16, True, False),     # d = 4, 3 tiles, ragged chunk
    (2, 4, 16, 50, 16, False, True),      # d = 4, shared, one short tile
    (2, 2, 20, 90, 32, True, False),      # d = 16 (2 rows a thread)
    (1, 2, 12, 65, 64, False, False),     # d = 32 (1 row a thread)
]


@pytest.mark.parametrize("B,H,L,K,E,masked,shared", F32_CASES, ids=str)
def test_f32_emulation_matches_pallas_and_plain(B, H, L, K, E, masked,
                                                shared):
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=L + K + E,
                            dtype=torch.float32)
    got = emulate_f32(q, k, v, bias, H)
    want = _pallas(H, q, k, v, bias)
    torch.testing.assert_close(got, want, **F32_TOL)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H)
    torch.testing.assert_close(got, plain, **F32_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"


@pytest.mark.parametrize("L", [1, 127, 128, 1000, 1024])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_f32_rows_per_thread_cover_each_row_once(L, R):
    rows = [r for rs in f32_thread_rows(L, R).values() for r in rs]
    assert sorted(rows) == list(range(L))


@pytest.mark.parametrize("case", [
    # (dtype, d, aligned) -> kernel
    ((torch.bfloat16, 32, True), "wgmma"),    # the appearance transformer
    ((torch.bfloat16, 16, True), "wgmma"),
    ((torch.bfloat16, 64, True), "wgmma"),
    ((torch.bfloat16, 128, True), "wgmma128"),  # the n_head 2 appearance
    ((torch.bfloat16, 32, False), "mma"),     # a base TMA cannot take
    ((torch.bfloat16, 4, True), "mma"),       # the motion width in bf16
    ((torch.bfloat16, 2, True), "mma"),       # the tiny config's widths
    ((torch.bfloat16, 8, True), "mma"),
    ((torch.bfloat16, 48, True), "mma"),      # no swizzle of 96-byte rows
    ((torch.bfloat16, 24, True), "mma"),
    ((torch.float32, 4, True), "f32"),        # the motion transformer
    ((torch.float32, 32, True), "f32"),
], ids=str)
def test_plan_kernel(case):
    (dtype, d, aligned), want = case
    ptr = 4096 if aligned else 4096 + 8
    assert port.plan(dtype, 16, 8, 1024, d, H100_SMS, 4096, ptr, 4096,
                     4096).kernel == want


@pytest.mark.parametrize("case", [
    # (B, H, L): a flagship frame batch (1024 blocks), the train step's B = 2
    # (256 blocks), tiny, and one block
    (16, 8, 1024), (2, 8, 1024), (4, 4, 64), (1, 1, 1)], ids=str)
def test_plan_wgmma_rows(case):
    """The wgmma kernel takes 64 query rows a block (one consumer
    warpgroup) at every grid: three such blocks share an SM."""
    B, H, L = case
    p = port.plan(torch.bfloat16, B, H, L, 32, H100_SMS, 0, 0, 0, 0)
    assert (p.kernel, p.rows) == ("wgmma", 64)


@pytest.mark.parametrize("case", [
    # (B, H, L, d) -> query rows per thread of the float32 kernel
    ((16, 8, 1024, 4), 2),    # a frame batch: 512 blocks at 2, 256 at 4
    ((32, 8, 1024, 4), 4),    # 512 blocks at 4
    ((2, 8, 1024, 4), 1),     # the train step's B = 2: 128 blocks at 1
    ((32, 8, 1024, 2), 4),
    ((32, 8, 1024, 8), 4),
    ((32, 8, 1024, 16), 2),   # 4 rows would crowd the registers
    ((64, 8, 1024, 32), 1),
    ((64, 8, 1024, 64), 1),
    ((4, 4, 64, 4), 1),       # tiny
], ids=str)
def test_plan_f32_rows(case):
    (B, H, L, d), rows = case
    assert port.plan(torch.float32, B, H, L, d, H100_SMS, 0, 0, 0,
                     0) == port.Plan("f32", rows)


def test_plan_mma_variant_is_tc_plan():
    """Where the mma.sync kernel runs, the plan carries tc_plan's variant
    and copy_bytes' copy width for k's and v's addresses; past its widths
    (d = 65) the plan is the d-chunked kernel's."""
    for d in (2, 4, 8, 12, 24, 48):
        nv, _, rows = port.tc_plan(2, 8, 1024, d, H100_SMS)
        p = port.plan(torch.bfloat16, 2, 8, 1024, d, H100_SMS, 0, 64, 64,
                      0)
        assert p == port.Plan("mma", rows, nv, port.copy_bytes(d, 64, 64))
    assert port.plan(torch.bfloat16, 1, 1, 1, 65, H100_SMS, 0, 0, 0,
                     0) == port.Plan("chunked", 64)


@pytest.mark.parametrize("case", [
    # (dtype, the tensor off 16 bytes) -> kernel at d = 256
    ((torch.bfloat16, None), "wgmma256"),
    ((torch.bfloat16, "q"), "chunked"),     # a base TMA cannot take
    ((torch.bfloat16, "k"), "chunked"),
    ((torch.bfloat16, "v"), "chunked"),
    ((torch.bfloat16, "out"), "chunked"),
    ((torch.float32, None), "f32wide"),
], ids=str)
def test_plan_d256(case):
    (dtype, off), want = case
    ptrs = [4096 + 2 * (name == off) for name in ("q", "k", "v", "out")]
    p = port.plan(dtype, 16, 1, 1024, 256, H100_SMS, *ptrs)
    rows = {"wgmma256": 64, "f32wide": port.f32wide_rows(256),
            "chunked": port.CHUNKED_ROWS[dtype]}
    assert p == port.Plan(want, rows[want])
