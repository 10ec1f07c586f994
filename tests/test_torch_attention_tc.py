"""Arithmetic of the bfloat16 tensor-core attention kernel (K1 and K2's
``attn_packed_kernel_tc`` in ``csrc/fused_attention_packed.cu``), emulated
in plain torch on the CPU, and its host-side variant choice.

The emulation follows the kernel step by step: keys in tiles of 64, keys
past K scored -inf; scores in log2 units (scale * log2(e) folded into one
multiply, the bias times log2(e) added); a running max from -FLT_MAX and
a running sum per row, the accumulator rescaled once per tile; exp2; p
split into bf16 hi + lo, both multiplied by the bf16 values into a float32
accumulator; the row sum from a ones column of v where ``tc_plan`` gives
the kernel one, else summed in float32; a row whose max is <= -1e29 (in
log2 units) outputs 0; one rounding to bf16. On bf16 inputs made from a
numpy seed it must agree with the JAX package's Pallas kernel in interpret
mode and with the port's plain version at ``chip_smoke.py``'s bf16
tolerance (atol 1e-3, rtol 2^-7: each side rounds a float32 result once
to bf16, so a result on a rounding boundary differs by one bf16 ulp).
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

ATOL, RTOL = 1e-3, 2 ** -7
TILE = 64                 # keys per stage of the kernel
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
FLT_MAX = torch.finfo(torch.float32).max
H100_SMS = 132


def _heads(t, B, H, K, d):
    """(B, K, E) or a shared (K, E) as (B, H, K, d), in float32."""
    return t.float().reshape(-1, K, H, d).permute(0, 2, 1, 3).expand(
        B, H, K, d)


def emulate(q, k, v, bias, num_heads):
    """The kernel's arithmetic on token-major bf16 inputs: q (B, L, E),
    k, v (B, K, E) or (K, E), bias (B, K) float32 or None; returns bf16
    (B, L, E)."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    nv, ones, _ = port.tc_plan(B, H, L, d, H100_SMS)
    width = 8 * nv
    qh = _heads(q, B, H, L, d)
    kh, vh = _heads(k, B, H, K, d), _heads(v, B, H, K, d)
    scale_log2 = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E
    m = torch.full((B, H, L), -FLT_MAX)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, width)
    for k0 in range(0, K, TILE):
        n = min(TILE, K - k0)
        kt = torch.zeros(B, H, TILE, d)
        kt[:, :, :n] = kh[:, :, k0:k0 + n]
        vt = torch.zeros(B, H, TILE, width)
        vt[:, :, :n, :d] = vh[:, :, k0:k0 + n]
        if ones:
            vt[..., d] = 1.0
        bl = torch.full((B, TILE), -math.inf)
        bl[:, :n] = 0.0 if bias is None else bias[:, k0:k0 + n] * LOG2E
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kt) * scale_log2 \
            + bl[:, None, None, :]
        m_new = torch.maximum(m, s.amax(-1))
        c = torch.exp2(m - m_new)
        m = m_new
        l, acc = l * c, acc * c[..., None]
        p = torch.exp2(s - m[..., None])
        if not ones:
            l = l + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        acc = acc + hi @ vt + lo @ vt
    den = acc[..., d] if ones else l
    out = acc[..., :d] / den[..., None]
    if bias is not None:
        keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
        out = torch.where(keep[..., None], out, torch.zeros(()))
    return out.permute(0, 2, 1, 3).reshape(B, L, E).bfloat16()


def _inputs(B, L, K, E, masked, shared, seed):
    """bf16 q, k, v (times 2, so the softmax is not flat) and a float32
    bias masking 30% of the keys and every key of batch row 0."""
    rng = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.from_numpy(2 * rng.randn(*shape).astype(
            np.float32)).bfloat16()

    q = bf16(B, L, E)
    kshape = (K, E) if shared else (B, K, E)
    k, v = bf16(*kshape), bf16(*kshape)
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


CASES = [
    # B, H, L, K, E, bias, shared
    (2, 8, 24, 100, 32, False, False),   # d = 4 (motion), ragged K
    (2, 8, 24, 70, 32, True, True),      # d = 4, shared codebook, bias
    (1, 8, 20, 130, 256, False, True),   # d = 32 (appearance), 3 tiles
    (2, 8, 16, 90, 256, True, False),    # d = 32, bias, ragged K
    (3, 8, 16, 50, 16, True, False),     # d = 2 (tiny motion), one tile
    (2, 4, 16, 128, 32, False, False),   # d = 8 (tiny appearance)
    (2, 2, 16, 72, 48, True, True),      # d = 24: ones column at nv = 4
    (1, 2, 16, 65, 128, False, False),   # d = 64: nv = 8
]


@pytest.mark.parametrize("B,H,L,K,E,masked,shared", CASES, ids=str)
def test_emulation_matches_pallas_and_plain(B, H, L, K, E, masked, shared):
    q, k, v, bias = _inputs(B, L, K, E, masked, shared, seed=L + K + E)
    got = emulate(q, k, v, bias, H).float()
    want = _pallas(H, q, k, v, bias)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H).float()
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
        assert want[0].abs().max().item() == 0.0
    assert torch.isfinite(got).all()


def test_split_keeps_sixteen_bits():
    """hi + lo carries each softmax weight to within 2^-16 of itself,
    where bf16(p) alone is off by up to 2^-9."""
    p = torch.exp2(-torch.rand(100000, generator=torch.Generator()
                               .manual_seed(0)) * 20)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    assert ((p - hi - lo).abs() <= 2 ** -16 * p).all()
    assert ((p - hi).abs() / p).max() > 2 ** -10


@pytest.mark.parametrize("d,want", [
    (2, (1, True)), (4, (1, True)), (7, (1, True)), (8, (1, False)),
    (12, (2, True)), (16, (2, False)), (24, (4, True)), (32, (4, False)),
    (33, (8, True)), (64, (8, False))], ids=str)
def test_tc_plan_width(d, want):
    assert port.tc_plan(16, 8, 1024, d, H100_SMS)[:2] == want


def test_tc_plan_every_width_has_a_variant():
    for d in range(2, 65):
        nv, ones, _ = port.tc_plan(1, 1, 1, d, H100_SMS)
        assert nv in port.TC_WIDTHS and 8 * nv >= d
        smaller = [n for n in port.TC_WIDTHS if n < nv]
        assert not smaller or 8 * smaller[-1] < d
        assert ones == (d < 8 * nv)
    # the widths the mma.sync kernel does not take: d = 1 to the d = 1
    # kernel, 65 to the d-chunked one
    for d, kernel in ((1, "d1"), (65, "chunked")):
        assert port.plan(torch.bfloat16, 1, 1, 1, d, H100_SMS, 0, 0, 0,
                         0).kernel == kernel


@pytest.mark.parametrize("case", [
    # (B, H, L, sms) -> query rows per block
    ((16, 8, 1024, 132), 128),   # a flagship frame batch: 1024 blocks
    ((2, 8, 1024, 132), 64),     # the train step's batch: 128 blocks
    ((4, 4, 64, 132), 64),       # tiny
    ((33, 2, 1024, 132), 128),   # exactly 4 blocks per SM
    ((32, 2, 1000, 132), 64)], ids=str)
def test_tc_plan_rows(case):
    (B, H, L, sms), want = case
    assert port.tc_plan(B, H, L, 32, sms)[2] == want


@pytest.mark.parametrize("case", [
    ((32, 0, 512), 16), ((4, 0, 64), 8), ((2, 0, 64), 4), ((8, 0, 8), 8),
    ((32, 0, 4), 4), ((3, 0, 0), 0), ((5, 2, 0), 0)], ids=str)
def test_copy_bytes(case):
    (d, *addresses), want = case
    assert port.copy_bytes(d, *addresses) == want


def test_wrapper_takes_plain_path_on_cpu_in_bf16():
    q, k, v, bias = _inputs(2, 16, 40, 32, True, False, seed=3)
    port.reset_launches()
    out = port.fused_attention_packed(q, k, v, bias, num_heads=8)
    ref = port.fused_attention_packed_reference(q, k, v, bias, num_heads=8)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert port.launches == 0 and port.split_launches == 0
