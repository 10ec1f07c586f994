"""The float32 wide kernel and the d = 1 kernel of
``csrc/fused_attention_chunked.cu`` (kernels K1 and K2 at float32 d =
65..1024 and at d = 1 in either dtype), on the CPU.

- ``attn_packed_kernel_f32wide<C>``'s arithmetic emulated in torch: d
  zero-padded to C = 128, 256, .., 1024 columns, q times scale * log2(e)
  first up to 256 (past it each score times it after q.k, in one FMA
  with the bias), keys in super-tiles of C up to 256 and of 512 past it
  (-inf past K), a running max from -FLT_MAX rescaling the sum and the
  accumulator once a super-tile (past 256 each row's max and sum taken
  over its warps' keys: two warps, kg < 32 and kg >= 32 of 64 key groups,
  up to 768, four of 128 past it; p.v in chunks of 16 keys, 8 at C =
  768 and 1024; at C = 640 and 768 256-key super-tiles), exp2, f32 weights, 0 for an all-masked row. Held against the
  JAX package's Pallas kernels in interpret mode and the plain version at
  d = 65, 96, 128, 160, 256, 257, 320, 384, 400, 511, 520, 640, 712, 776
  and 1024, ragged L and K over two super-tiles, a shared context, in both
  layouts, at ``chip_smoke.py``'s float32 tolerance (2e-5). Above 1024 float32 stays on the d-chunked
  kernel, emulated at d = 1032.
- The d = 1 kernel in bfloat16: bf16 q, k and v widened to f32, the
  float32 d = 1 kernel's arithmetic, one rounding, at one bf16 ulp.
- ``plan``'s routing of these widths, and the pairs that
  ``chip_attention_choice.py`` times.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import chip_attention_choice as choice  # noqa: E402
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from test_torch_attention_wgmma import (  # noqa: E402
    BF16_TOL,
    F32_TOL,
    FLT_MAX,
    H100_SMS,
    LOG2E,
    _heads,
)
from test_torch_attention_widths import (  # noqa: E402
    _inputs,
    _pallas,
    emulate_chunked,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401


def wide_columns(d):
    """The padded width C of the kernel instance that takes d (its rows
    per block are 16384 / C up to 256, 32 up to 768 and 16 past it, its
    keys per super-tile C up to 256, 256 at 640 and 768 and 512 else)."""
    return -(-d // 128) * 128


def super_tile(C):
    """Keys a super-tile of the instance at C."""
    return C if C <= 256 else 256 if 512 < C <= 768 else 512


def wide_v_keys(C):
    """Keys a v chunk past C = 256."""
    return 8 if C in (768, 1024) else 16


def key_groups(C):
    """A row's lanes (key groups) past C = 256: 64 (two warps) up to 768,
    128 (four warps) past it, each holding keys kg + TK j."""
    return 64 if C <= 768 else 128


def emulate_f32wide(q, k, v, bias, num_heads):
    """The float32 wide kernel's arithmetic on token-major float32 inputs:
    q (B, L, E), k, v (B, K, E) or (K, E), bias (B, K) float32 or None;
    returns (B, L, E)."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    C = wide_columns(d)
    KS = super_tile(C)
    # past 256 a row's keys kg + TK j lie in warp kg // 32 of its TK / 32
    warp = torch.arange(KS) % key_groups(C) // 32
    warps = [warp == w for w in range(key_groups(C) // 32)]

    def pad(t):  # zero past d, up to C columns
        return torch.nn.functional.pad(t, (0, C - d))

    sl2 = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E
    qh = pad(_heads(q, B, H, L, d))
    if C <= 256:
        qh = qh * sl2  # q staged times scale_log2
    kh, vh = pad(_heads(k, B, H, K, d)), pad(_heads(v, B, H, K, d))
    m = torch.full((B, H, L), -FLT_MAX)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, C)
    for k0 in range(0, K, KS):  # super-tiles of KS keys
        n = min(KS, K - k0)
        kt = torch.zeros(B, H, KS, C)  # zero past K
        kt[:, :, :n] = kh[:, :, k0:k0 + n]
        vt = torch.zeros(B, H, KS, C)
        vt[:, :, :n] = vh[:, :, k0:k0 + n]
        bl = torch.full((B, KS), -math.inf)
        bl[:, :n] = 0.0 if bias is None else bias[:, k0:k0 + n] * LOG2E
        if C <= 256:
            s = qh @ kt.transpose(-1, -2) + bl[:, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            c = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(s - m[..., None])
            l = l * c + p.sum(-1)
            acc = acc * c[..., None] + p @ vt
            continue
        # the scores to log2 units in one FMA with the bias; each warp's
        # max of the row (from -FLT_MAX), then both warps' sums
        s = torch.addcmul(bl[:, None, None, :], qh @ kt.transpose(-1, -2),
                          sl2)
        mx = torch.stack([torch.clamp(s[..., w].amax(-1), min=-FLT_MAX)
                          for w in warps]).amax(0)
        m_new = torch.maximum(m, mx)
        c = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(s - m[..., None])
        l = l * c
        for w in warps:  # the warps' sums, in order
            l = l + p[..., w].sum(-1)
        acc = acc * c[..., None]
        vk = wide_v_keys(C)
        for j0 in range(0, KS, vk):  # v chunks, in order
            acc = acc + p[..., j0:j0 + vk] @ vt[:, :, j0:j0 + vk]
    o = acc / l[..., None]
    if bias is not None:
        keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
        o = torch.where(keep[..., None], o, torch.zeros(()))
    return o[..., :d].permute(0, 2, 1, 3).reshape(B, L, E)


def _token_major(q, k, v):
    """Head-split q (B, H, L, d), k, v (B or 1, H, K, d) as token-major
    q (B, L, E) and k, v (B, K, E), or (K, E) for a shared context."""
    def merge(t):
        n, H, T, d = t.shape
        return t.permute(0, 2, 1, 3).reshape(n, T, H * d)

    B = q.shape[0]
    kk, vv = merge(k), merge(v)
    if k.shape[0] == 1 and B != 1:
        kk, vv = kk[0], vv[0]
    return merge(q), kk, vv


def _split(out, H):
    B, L, E = out.shape
    return out.reshape(B, L, H, E // H).permute(0, 2, 1, 3)


WIDE_CASES = [
    # d, H, B, L, K, bias, shared
    (65, 2, 2, 18, 140, True, False),   # one column past 64, C = 128
    (96, 2, 2, 20, 129, False, True),   # shared codebook, one-key tile
    (128, 1, 2, 17, 200, True, False),  # C = 128, two super-tiles
    (160, 1, 2, 16, 270, True, True),   # C = 256, ragged K
    (256, 1, 2, 19, 260, True, False),  # two super-tiles of 256
    (257, 1, 2, 18, 70, True, True),    # C = 384, one column past 256
    (320, 1, 2, 20, 600, True, False),  # C = 384, two super-tiles of 512
    (384, 2, 1, 17, 530, False, True),  # C = 384, shared, a short tile
    (400, 1, 2, 9, 100, True, False),   # C = 512, 112 zero columns
    (511, 1, 2, 12, 520, True, True),   # C = 512, d % 4 = 3
    (520, 1, 2, 18, 70, True, False),    # C = 640, 120 zero columns
    (640, 1, 2, 40, 600, True, True),    # three 256-key super-tiles
    (712, 1, 1, 33, 300, True, False),   # C = 768: 8-key v chunks
    (776, 1, 1, 17, 130, False, False),  # C = 896: four warps a row
    (1024, 1, 2, 9, 600, True, True),    # two super-tiles of 512
]


@pytest.mark.parametrize("split", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("d,H,B,L,K,masked,shared", WIDE_CASES, ids=str)
def test_f32wide_emulation_matches_pallas_and_plain(d, H, B, L, K, masked,
                                                    shared, split):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=d + K,
                            split=split)
    assert port.plan(torch.float32, B, H, L, d, H100_SMS, 0, 0, 0,
                     0) == port.Plan("f32wide", 16384 // wide_columns(d)
                                     if d <= 256 else 32 if d <= 768
                                     else 16)
    got = emulate_f32wide(*(_token_major(q, k, v) if split else (q, k, v)),
                          bias, H)
    if split:
        got = _split(got, H)
    torch.testing.assert_close(got, _pallas(H, q, k, v, bias, split),
                               **F32_TOL)
    plain = (port.fused_attention_reference(q, k, v, bias) if split else
             port.fused_attention_packed_reference(q, k, v, bias,
                                                   num_heads=H))
    torch.testing.assert_close(got, plain, **F32_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
    assert torch.isfinite(got).all()


def test_f32_above_256_stays_on_the_d_chunked_kernel():
    """float32 above 256: d = 320 runs the wide kernel at C = 384 (32 rows
    a block, 512-key super-tiles), d = 512 at C = 512 and d = 640 at C =
    640 (32 rows, 256-key super-tiles), whose arithmetic matches the
    Pallas kernel and the plain version; only above F32WIDE_MAX_D = 1024
    (d = 1032 here) plan keeps the d-chunked kernel (<16, 64>: seventeen
    64-column blocks, each repeating q.k), whose arithmetic matches
    them too."""
    for d, K, want, emulate in (
            (320, 90, port.Plan("f32wide", 32), emulate_f32wide),
            (512, 40, port.Plan("f32wide", 32), emulate_f32wide),
            (640, 40, port.Plan("f32wide", 32), emulate_f32wide),
            (1032, 40, port.Plan("chunked", 128), emulate_chunked)):
        H, B, L = 1, 2, 17
        assert port.plan(torch.float32, B, H, L, d, H100_SMS, 0, 0, 0,
                         0) == want
        q, k, v, bias = _inputs(B, H, L, K, d, True, True, seed=11)
        got = emulate(q, k, v, bias, H)
        torch.testing.assert_close(got, _pallas(H, q, k, v, bias),
                                   **F32_TOL)
        torch.testing.assert_close(
            got, port.fused_attention_packed_reference(q, k, v, bias,
                                                       num_heads=H),
            **F32_TOL)
        assert got[0].abs().max().item() == 0.0


D1_CASES = [
    # H, B, L, K, bias, shared
    (4, 2, 20, 70, True, False),
    (8, 2, 16, 40, False, True),
    (32, 1, 9, 130, True, True),
]


@pytest.mark.parametrize("split", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("H,B,L,K,masked,shared", D1_CASES, ids=str)
def test_d1_bf16_emulation_matches_pallas_and_plain(H, B, L, K, masked,
                                                    shared, split):
    """bfloat16 d = 1 on the CUDA-core d = 1 kernel: the float32
    instance's arithmetic (one row a thread, 64-key tiles, a one-column
    q.k chunk) on the widened inputs, rounded once to bf16."""
    q, k, v, bias = _inputs(B, H, L, K, 1, masked, shared, seed=K + L,
                            dtype=torch.bfloat16, split=split)
    assert port.plan(torch.bfloat16, B, H, L, 1, H100_SMS, 0, 0, 0,
                     0) == port.Plan("d1", port.D1_ROWS)
    tq, tk, tv = _token_major(q, k, v) if split else (q, k, v)
    got = emulate_chunked(tq.float(), tk.float(), tv.float(), bias,
                          H).to(torch.bfloat16)
    if split:
        got = _split(got, H)
    torch.testing.assert_close(got.float(), _pallas(H, q, k, v, bias, split),
                               **BF16_TOL)
    plain = (port.fused_attention_reference(q, k, v, bias) if split else
             port.fused_attention_packed_reference(q, k, v, bias,
                                                   num_heads=H))
    assert plain.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plan_routes_d1_and_f32_wide_at_any_address(dtype):
    """d = 1 goes to the d = 1 kernel and float32 65..1024 to the wide
    kernel at every address (neither reads through TMA), and the C
    entry's kernel argument names each."""
    for ptr in (4096, 4096 + 4, 4096 + 2 * (dtype == torch.bfloat16)):
        for B, H, L in ((16, 32, 1024), (1, 1, 1)):
            assert port.plan(dtype, B, H, L, 1, H100_SMS, ptr, ptr, ptr,
                             ptr) == port.Plan("d1", 128)
            for d in (65, 97, 128, 129, 200, 256, 257, 320, 385, 511, 512,
                      513, 640, 641, 777, 1023, 1024):
                want = (port.Plan("f32wide", 128 if d <= 128 else
                                  64 if d <= 256 else 32 if d <= 768
                                  else 16)
                        if dtype == torch.float32
                        else port.plan(dtype, B, H, L, d, H100_SMS, ptr,
                                       ptr, ptr, ptr))
                assert port.plan(dtype, B, H, L, d, H100_SMS, ptr, ptr, ptr,
                                 ptr) == want
                if dtype == torch.bfloat16:
                    assert want.kernel != "f32wide"
    assert port.F32WIDE_MAX_D == 1024
    assert [port.f32wide_cols(d) for d in (65, 128, 129, 256, 257, 384,
                                           385, 511, 513, 640, 641, 768,
                                           769, 896, 897, 1024)] == [
        128, 128, 256, 256, 384, 384, 512, 512, 640, 640, 768, 768, 896,
        896, 1024, 1024]
    assert port.CHUNKED_ENTRY_KERNELS == {"chunked": 0, "d1": 1,
                                          "f32wide": 2}


def test_choice_times_each_new_kernel_against_the_one_it_replaced():
    """chip_attention_choice.py: at float32 d = 256 and 128 the wide
    kernel against the d-chunked one, at bfloat16 d = 1 the d = 1 kernel
    against the d-chunked tensor-core one, at float32 d = 1 the d = 1
    kernel against the CUDA-core kernel of fused_attention_packed.cu; its
    widths are the six it names."""
    def kernels(dtype, H, d):
        return [p.kernel for p in choice.candidates(port, dtype, 16, H, 1024,
                                                    d, H100_SMS)]

    assert kernels(torch.float32, 1, 256) == ["f32wide", "chunked"]
    assert kernels(torch.float32, 2, 128) == ["f32wide", "chunked"]
    assert kernels(torch.bfloat16, 32, 1) == ["d1", "chunked"]
    assert kernels(torch.float32, 32, 1) == ["d1", "f32"]
    assert choice.candidates(port, torch.float32, 16, 1, 1024, 256,
                             H100_SMS)[1] == port.Plan("chunked", 128)
    assert choice.WIDTHS == [
        (32, "motion", torch.float32), (32, "motion", torch.bfloat16),
        (32, "app", torch.bfloat16), (1, "app", torch.bfloat16),
        (1, "app", torch.float32), (2, "app", torch.float32)]



def wide_geometry(C):
    """attn_packed_kernel_f32wide<C>'s Wide<C>, as the source computes it:
    rows R, keys a super-tile KS, keys of a thread's score tile KJ, depth
    and key chunks DK and VK, row and key groups TR and TK, O's second
    column group W2, shared bytes."""
    wide, huge = C > 256, C > 512
    R = (32 if C <= 768 else 16) if huge else 32 if wide else 16384 // C
    KS = super_tile(C)
    KJ = 4 if huge else 8
    DK = 32 if huge and C <= 768 else 16 if wide else 8192 // C
    VK = wide_v_keys(C) if wide else 8192 // C
    TR, TK = R // 8, KS // KJ
    W2 = (C - 4 * TK) // TK
    qs, ks, ps = C + 4, DK + 4, R + 4
    slot = max(KS * ks, VK * qs)
    stats = 4 + 2 * (TK // 32) if wide else 4
    smem = 4 * (R * qs + KS * ps + 2 * slot + stats * R)
    return dict(R=R, KS=KS, KJ=KJ, DK=DK, VK=VK, TR=TR, TK=TK, W2=W2,
                smem=smem)


@pytest.mark.parametrize("C", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_f32wide_threads_cover_rows_keys_and_columns_once(C):
    """Each of the 256 threads holds rows rg + TR i and keys kg + TK j of
    the scores, and rows rg + TR i and columns 4 kg .. + 3 and 4 TK + W2 kg
    .. + W2 - 1 of O (past C = 512, 4 TK + TK e + kg, e < W2): every (row,
    key) and (row, column) of a block once; a v chunk never crosses its
    super-tile; the block fits the SM's shared memory (one block an SM)."""
    g = wide_geometry(C)
    scores, outs = [], []
    for tid in range(256):
        rg, kg = tid // g["TK"], tid % g["TK"]
        rows = [rg + g["TR"] * i for i in range(8)]
        scores += [(r, kg + g["TK"] * j) for r in rows
                   for j in range(g["KJ"])]
        second = ([4 * g["TK"] + g["TK"] * e + kg for e in range(g["W2"])]
                  if C > 512 else
                  [4 * g["TK"] + g["W2"] * kg + e for e in range(g["W2"])])
        cols = [4 * kg + e for e in range(4)] + second
        outs += [(r, c) for r in rows for c in cols]
    assert sorted(scores) == [(r, k) for r in range(g["R"])
                              for k in range(g["KS"])]
    assert sorted(outs) == [(r, c) for r in range(g["R"]) for c in range(C)]
    assert g["KS"] % g["VK"] == 0 and g["VK"] % 8 == 0
    assert g["smem"] <= 232448
    # a row's key groups: one warp (or half) up to 256, two warps up to
    # 768, four past it
    assert g["TK"] == (128 if C > 768 else 64 if C > 256 else C // 8)
    assert g["TK"] == (key_groups(C) if C > 256 else C // 8)
    assert port.f32wide_rows(C) == g["R"] and port.f32wide_cols(C) == C
