"""Attention at every head width the JAX package takes (kernels K1 and K2
outside the shipped d = 4 and 32), on the CPU.

- The plain versions of K1 (token-major) and K2 (head-split) against the
  JAX package's Pallas kernels in interpret mode at d = 1, 96, 128 and
  256, tiny L and K, with and without a bias that masks every key of batch
  row 0 (whose output is then 0), per-row and shared k and v: float32 on
  both sides, the same formula summed in another order, within 1e-5.
- The d-chunked kernels' arithmetic (``csrc/fused_attention_chunked.cu``),
  emulated in torch: blocks of at most 64 output columns, each computing
  the full q.k over d in column chunks (64 in bf16, 16 in float32, 1 at
  d = 1), keys in tiles of 64 (-inf past K), scores in log2 units, a
  running max from -FLT_MAX rescaling the accumulator once a tile, exp2,
  p as bf16 hi + lo in bf16 (f32 FMAs in float32), the row sum in f32, 0
  for an all-masked row, one rounding. Held against the Pallas kernel and
  the plain version at ``chip_smoke.py``'s tolerances (bf16: atol 1e-3,
  rtol 2^-7, one bf16 ulp; float32 2e-5).
- ``plan`` for every d in 1..1025 in both dtypes (no raise; d = 2..64 as
  before this kernel; bf16 d = 128 on the d = 128 wgmma kernel, d = 256 on
  the d = 256 wgmma kernel, 257..512 on the d = 512 one), and the
  per-kernel counts
  that ``chip_smoke.py``'s attention_widths phase expects at n_head 1, 2,
  8 and 32; the flagship generator's layers and parameters at n_head 1, 2
  and 32.
- The tiny generator with motion d = 1 and appearance d = 128
  (``chip_smoke.HEAD_WIDTHS["tiny_d1_d128"]``) against JAX inference, at
  ``test_torch_models``' generator bound of 2e-4: the port's seeded weights
  through the tools' converter, the port's motion estimator's dense motion
  fed to both; one jitted JAX generator.
"""
import math
import sys
from os import path as osp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "tools"))

import chip_smoke  # noqa: E402
from convert_reference_checkpoint import convert_net_g  # noqa: E402

from synergize_motion_appearance_tpu.models import (  # noqa: E402
    build_network as jax_build,
)
from synergize_motion_appearance_tpu.ops.fused_attention import (  # noqa: E402
    _fused_attention_packed_pallas,
    _fused_attention_pallas,
)
from synergize_motion_appearance_tpu_torch import configs, weights  # noqa: E402
from synergize_motion_appearance_tpu_torch.models import (  # noqa: E402
    build_network,
)
from synergize_motion_appearance_tpu_torch.models.transformer import (  # noqa: E402
    MultiheadAttention,
)
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
from test_torch_models import _images, _nchw, _nhwc, _perturb  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401

PLAIN_TOL = dict(atol=1e-5, rtol=1e-5)
COLS, KEYS = 64, 64  # output columns a block; keys a tile (both kernels)


def _inputs(B, H, L, K, d, masked, shared, seed, dtype=torch.float32,
            split=False):
    """q, k, v (times 2, so the softmax is not flat) in ``dtype``, in the
    token-major layout or (``split``) the head-split one, and a float32
    (B, K) bias masking 30% of the keys and every key of batch row 0."""
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.from_numpy(2 * rng.randn(*shape).astype(
            np.float32)).to(dtype)

    E = H * d
    if split:
        q = randn(B, H, L, d)
        k, v = randn(1 if shared else B, H, K, d), randn(
            1 if shared else B, H, K, d)
    else:
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


def _j(t):
    return None if t is None else jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _pallas(H, q, k, v, bias, split=False):
    if split:
        out = _fused_attention_pallas(_j(q), _j(k), _j(v), _j(bias),
                                      interpret=True)
    else:
        out = _fused_attention_packed_pallas(H, _j(q), _j(k), _j(v),
                                             _j(bias), interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _plain(H, q, k, v, bias, split=False):
    if split:
        return port.fused_attention_reference(q, k, v, bias)
    return port.fused_attention_packed_reference(q, k, v, bias, num_heads=H)


PLAIN_CASES = [
    # d, H, B, L, K, bias, shared
    (1, 4, 2, 16, 24, True, False),
    (1, 2, 2, 20, 33, False, True),
    (96, 2, 2, 24, 40, True, True),
    (128, 2, 2, 16, 48, True, False),
    (128, 1, 1, 32, 17, False, True),
    (256, 1, 2, 24, 40, True, False),
    (256, 2, 1, 16, 24, False, True),
]


@pytest.mark.parametrize("split", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("d,H,B,L,K,masked,shared", PLAIN_CASES, ids=str)
def test_plain_matches_pallas_interpret(d, H, B, L, K, masked, shared,
                                        split):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=d + L + K,
                            split=split)
    want = _pallas(H, q, k, v, bias, split)
    got = _plain(H, q, k, v, bias, split)
    torch.testing.assert_close(got, want, **PLAIN_TOL)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
        assert want[0].abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# the d-chunked kernels' arithmetic
# ---------------------------------------------------------------------------

def emulate_chunked(q, k, v, bias, num_heads):
    """The d-chunked kernels' arithmetic on token-major inputs of either
    dtype: q (B, L, E), k, v (B, K, E) or (K, E), bias (B, K) float32 or
    None; returns (B, L, E) in q's dtype. Each block of COLS output
    columns repeats the q.k and the softmax of its head (the same
    arithmetic, so the same p) and accumulates p.v over its columns."""
    B, L, E = q.shape
    H = num_heads
    d = E // H
    K = k.shape[-2]
    bf16 = q.dtype == torch.bfloat16
    qh = _heads(q, B, H, L, d)
    kh, vh = _heads(k, B, H, K, d), _heads(v, B, H, K, d)
    sl2 = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * LOG2E
    qc = COLS if bf16 else (1 if d == 1 else 16)  # columns a q.k chunk
    if not bf16:
        qh = qh * sl2  # float32: q staged times scale * log2(e)
    out = torch.zeros(B, H, L, d)
    for c_out in range(0, d, COLS):  # the blocks of one head
        w = min(COLS, d - c_out)
        m = torch.full((B, H, L), -FLT_MAX)
        l = torch.zeros(B, H, L)
        acc = torch.zeros(B, H, L, w)
        for k0 in range(0, K, KEYS):
            n = min(KEYS, K - k0)
            kt = torch.zeros(B, H, KEYS, d)  # zero past K
            kt[:, :, :n] = kh[:, :, k0:k0 + n]
            vt = torch.zeros(B, H, KEYS, w)
            vt[:, :, :n] = vh[:, :, k0:k0 + n, c_out:c_out + w]
            bl = torch.full((B, KEYS), -math.inf)
            bl[:, :n] = 0.0 if bias is None else bias[:, k0:k0 + n] * LOG2E
            s = torch.zeros(B, H, L, KEYS)
            for c0 in range(0, d, qc):  # q.k over d, a chunk at a time
                s = s + qh[..., c0:c0 + qc] @ kt[..., c0:c0 + qc].transpose(
                    -1, -2)
            if bf16:
                s = s * sl2 + bl[:, None, None, :]
            else:
                s = s + bl[:, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            c = torch.exp2(m - m_new)
            m = m_new
            l, acc = l * c, acc * c[..., None]
            p = torch.exp2(s - m[..., None])
            l = l + p.sum(-1)
            if bf16:
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float()
                acc = acc + hi @ vt + lo @ vt
            else:
                acc = acc + p @ vt
        o = acc / l[..., None]
        if bias is not None:
            keep = m > torch.tensor(-1e29, dtype=torch.float32) * LOG2E
            o = torch.where(keep[..., None], o, torch.zeros(()))
        out[..., c_out:c_out + w] = o
    return out.permute(0, 2, 1, 3).reshape(B, L, E).to(q.dtype)


CHUNKED_CASES = [
    # d, H, B, L, K, bias, shared
    (1, 4, 2, 20, 70, True, False),    # d = 1: one column, two key tiles
    (1, 8, 2, 16, 40, False, True),    # d = 1, shared codebook
    (65, 2, 2, 18, 64, True, False),   # one column past a chunk
    (96, 2, 2, 20, 130, False, True),  # 1.5 chunks, 3 key tiles, shared
    (160, 1, 2, 17, 90, True, True),   # 2.5 chunks, ragged K
    (256, 1, 2, 16, 65, True, False),  # 4 chunks, a one-key last tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,H,B,L,K,masked,shared", CHUNKED_CASES, ids=str)
def test_chunked_emulation_matches_pallas_and_plain(d, H, B, L, K, masked,
                                                    shared, dtype):
    q, k, v, bias = _inputs(B, H, L, K, d, masked, shared, seed=d + K,
                            dtype=dtype)
    # plan sends bf16 above 64 here where TMA cannot take an address (q
    # here); float32 65..256 to the wide kernel and d = 1 to the d = 1
    # kernel (tests/test_torch_attention_f32wide.py), where the d-chunked
    # kernels still run when named (chip_attention_choice.py times them)
    want = ("d1" if d == 1 else "f32wide" if dtype == torch.float32
            else "chunked")
    assert port.plan(dtype, B, H, L, d, H100_SMS, 2, 0, 0,
                     0).kernel == want
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    got = emulate_chunked(q, k, v, bias, H).float()
    torch.testing.assert_close(got, _pallas(H, q, k, v, bias), **tol)
    plain = port.fused_attention_packed_reference(q, k, v, bias,
                                                  num_heads=H).float()
    torch.testing.assert_close(got, plain, **tol)
    if masked:
        assert got[0].abs().max().item() == 0.0, "all-masked batch row"
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def _plan_before(dtype, B, H, L, d, sms, q_ptr, k_ptr, v_ptr, out_ptr):
    """plan's choice at d = 2..64 before the d-chunked kernel: float32 on
    the CUDA-core kernel, bfloat16 at d = 16, 32, 64 with aligned pointers
    on wgmma, else on mma.sync."""
    if dtype == torch.float32:
        return port.Plan("f32", port.f32_rows(B, H, L, d, sms))
    if d in (16, 32, 64) and all(a % 16 == 0 for a in (q_ptr, k_ptr, v_ptr,
                                                       out_ptr)):
        return port.Plan("wgmma", 64)
    nv, _, rows = port.tc_plan(B, H, L, d, sms)
    return port.Plan("mma", rows, nv, port.copy_bytes(d, k_ptr, v_ptr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plan_takes_every_width(dtype):
    """Every d in 1..1025 gets a kernel, aligned or not; d = 2..64 the one
    it got before; d = 1 the d = 1 kernel; float32 65..1024 the wide
    kernel; bf16 at aligned pointers and d % 8 = 0 the d = 128 wgmma
    design at 65..128, the d = 256 one at 129..256 and the d = 512 one at
    257..512; the rest past 64 (float32 above 1024, bf16 above 512) the
    d-chunked kernel."""
    for d in range(1, 1026):
        for ptr in (4096, 4096 + 8):
            for B, H, L in ((16, 8, 1024), (2, 1, 33)):
                got = port.plan(dtype, B, H, L, d, H100_SMS, 4096, ptr, 4096,
                                4096)
                if 2 <= d <= 64:
                    assert got == _plan_before(dtype, B, H, L, d, H100_SMS,
                                               4096, ptr, 4096, 4096), d
                elif (dtype == torch.bfloat16 and d % 8 == 0
                      and 64 < d <= 128 and ptr == 4096):
                    assert got == port.Plan("wgmma128", 128)
                elif (dtype == torch.bfloat16 and d % 8 == 0
                      and 128 < d <= 256 and ptr == 4096):
                    assert got == port.Plan("wgmma256", 64)
                elif (dtype == torch.bfloat16 and d % 8 == 0
                      and 256 < d <= 512 and ptr == 4096):
                    assert got == port.Plan("wgmma512", 64)
                elif d == 1:
                    assert got == port.Plan("d1", 128)
                elif dtype == torch.float32 and d <= 1024:
                    assert got == port.Plan(
                        "f32wide", 128 if d <= 128 else
                        64 if d <= 256 else 32 if d <= 768 else 16), d
                else:
                    assert got == port.Plan("chunked",
                                            port.CHUNKED_ROWS[dtype]), d


@pytest.mark.parametrize("case", [
    # (dtype, aligned) -> kernel at d = 128
    ((torch.bfloat16, True), "wgmma128"),
    ((torch.bfloat16, False), "chunked"),   # a base TMA cannot take
    ((torch.float32, True), "f32wide"),
], ids=str)
def test_plan_d128(case):
    (dtype, aligned), want = case
    ptr = 4096 if aligned else 4096 + 2
    assert port.plan(dtype, 16, 2, 1024, 128, H100_SMS, ptr, 4096, 4096,
                     4096).kernel == want


def test_plan_and_check_refuse_width_0():
    with pytest.raises(ValueError, match="head width d=0"):
        port.plan(torch.float32, 1, 1, 1, 0, H100_SMS, 0, 0, 0, 0)
    q = torch.zeros(1, 2, 3, 0)
    with pytest.raises(ValueError, match="head width d=0"):
        port._check_cuda(q, q, q, None, None)


@pytest.mark.parametrize("case", [
    # n_head -> the kernels of one flagship frame batch's 32 K1 launches
    (1, {"f32": 16, "wgmma256": 16}),  # motion d = 32, appearance 256
    (2, {"f32": 16, "wgmma128": 16}),  # motion d = 16, appearance 128
    (8, {"f32": 16, "wgmma": 16}),     # shipped: d = 4 and 32
    (32, {"d1": 16, "mma": 16}),       # motion d = 1, appearance 8
], ids=str)
def test_head_width_kernels(case):
    H, want = case
    assert chip_smoke.head_width_kernels(torch, port, H, H100_SMS) == want


def test_choice_times_every_d256_variant():
    """chip_attention_choice.py times, at the n_head 1 appearance shapes
    (bf16 d = 256), plan's kernel first (the d = 256 wgmma kernel, its
    only variant), then the d-chunked kernel; at n_head 32 plan's kernel
    and the one other kernel of each width."""
    import chip_attention_choice as choice

    plans = choice.candidates(port, torch.bfloat16, 16, 1, 1024, 256,
                              H100_SMS)
    assert plans == [port.Plan("wgmma256", 64), port.Plan("chunked", 64)]
    assert [p.kernel for p in choice.candidates(
        port, torch.float32, 16, 32, 1024, 1, H100_SMS)] == ["d1", "f32"]
    assert [p.kernel for p in choice.candidates(
        port, torch.bfloat16, 16, 32, 1024, 8, H100_SMS)] == ["mma",
                                                              "chunked"]


def test_width_halves_sum_by_half_dtype_and_kernel():
    """chip_smoke.width_halves: the timed rows of one n_head summed per
    frame batch by half, dtype, width and kernel; checked-only rows (no
    launches a frame batch, or no time) left out."""
    def row(case, dtype, d, kernel, per, ms):
        r = {"case": case, "dtype": dtype, "d": d, "kernel": kernel,
             "launches_per_frame_batch": per}
        if ms is not None:
            r.update(device_ms=ms, library_device_ms=2 * ms,
                     bound_ms=ms / 4)
        return r

    rows = [row("app_self", "bfloat16", 256, "wgmma256", 4, 0.05),
            row("app_cross_K256", "bfloat16", 256, "wgmma256", 2, 0.02),
            row("app_self", "float32", 256, "chunked", 4, 1.0),
            row("motion_self", "float32", 32, "f32", 8, 0.1),
            row("ragged_L1000_K333_d256", "bfloat16", 256, "wgmma256", 0,
                None)]
    got = chip_smoke.width_halves(rows)
    assert set(got) == {"appearance_bfloat16_d256_wgmma256",
                        "appearance_float32_d256_chunked",
                        "motion_float32_d32_f32"}
    h = got["appearance_bfloat16_d256_wgmma256"]
    assert h["launches"] == 6
    assert h["device_ms"] == pytest.approx(4 * 0.05 + 2 * 0.02)
    assert h["library_device_ms"] == pytest.approx(2 * h["device_ms"])
    assert h["bound_share"] == pytest.approx(0.25)
    k2 = [dict(r, k1_launches_per_frame_batch=r.pop(
        "launches_per_frame_batch")) for r in rows]
    assert chip_smoke.width_halves(
        k2, "k1_launches_per_frame_batch") == got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_bound_counts_the_functions_products(dtype):
    """chip_smoke.attention_bound at the appearance transformer's n_head 2
    shape (d = 128, where the products bind): 4d FLOP a score, the
    function's q.k and p.v, in either dtype; the bf16 kernels' hi + lo
    p.v (6d a score) only as the separate hilo_products_ms."""
    B, L, K, E, H = 2, 64, 48, 256, 2
    d = E // H
    q = torch.zeros(B, L, E, dtype=dtype)
    k = v = torch.zeros(B, K, E, dtype=dtype)
    scores = B * H * L * K
    rate = {"exp_per_s": 1e30}  # the exponentials never bind here
    got = chip_smoke.attention_bound(q, k, v, None, scores, d, rate)
    peak = chip_smoke.PEAK_FLOPS[str(dtype).split(".")[1]]
    products = 1e3 * 4 * d * scores / peak
    nbytes = 1e3 * (2 * q.numel() + 2 * k.numel()) * q.element_size() / (
        chip_smoke.HBM_BYTES_PER_S)
    assert got["bound_ms"] == pytest.approx(max(products, nbytes))
    assert got["bound_by"] == ("operations" if products > nbytes
                               else "bytes")
    if dtype == torch.bfloat16:
        assert got["hilo_products_ms"] == pytest.approx(1.5 * products)
    else:
        assert "hilo_products_ms" not in got


@pytest.mark.parametrize("case", [
    # (device ms recorded, queued ms left at the last launch, lost)
    (10.0, 10.5, False),   # the device's work, its gaps not recorded
    (2.0, 10.0, True),     # a fifth of it, as seen late in a long process
    (0.0, 10.0, True),     # nothing
    (0.02, 0.1, False),    # short calls: the first launch's latency
    (1.0, -3.0, False),    # the host held the device back
], ids=str)
def test_activity_lost(case):
    device, pending, lost = case
    assert chip_smoke.activity_lost(device, pending) is lost


@pytest.mark.parametrize("n_head", chip_smoke.HEAD_COUNTS)
def test_flagship_generator_takes_n_head(n_head):
    """The flagship generator at n_head 1, 2 and 32 (built without
    memory, on the meta device): every attention layer takes the n_head,
    and the parameters, which the JAX package's n_head does not shape
    either, are those of the shipped n_head 8, so weights.py carries the
    same JAX tree across."""
    def shapes(cfg):
        with torch.device("meta"):
            g = build_network(cfg["network_g"])
        return g, {key: tuple(val.shape)
                   for key, val in g.state_dict().items()}

    g, got = shapes(chip_smoke.ablation_cfg(configs.get("flagship_256"),
                                            f"n_head_{n_head}"))
    _, want = shapes(configs.get("flagship_256"))
    assert got == want
    heads = {m.num_heads for m in g.modules()
             if isinstance(m, MultiheadAttention)}
    assert heads == {n_head}


# ---------------------------------------------------------------------------
# the tiny generator at motion d = 1 and appearance d = 128
# ---------------------------------------------------------------------------

def tiny_widths_cfg():
    return chip_smoke.ablation_cfg(configs.get("tiny"), "tiny_d1_d128")


def test_tiny_variant_widths():
    g = tiny_widths_cfg()["network_g"]
    assert g["dim_embd_motion"] // g["n_head"] == 1
    assert g["dim_embd_app"] // g["n_head"] == 128


def test_tiny_generator_matches_jax_inference():
    """AppMotionCompFormer(inference=True) with motion d = 1 and appearance
    d = 128 against the JAX generator, same weights and dense motion."""
    cfg = tiny_widths_cfg()
    g, me = weights.seeded_nets(cfg, 0)
    g_vars, unused = convert_net_g(
        {key: val.numpy() for key, val in g.state_dict().items()},
        cfg["network_g"])
    assert not unused
    g_vars = _perturb(g_vars, 2)
    tg = build_network(cfg["network_g"])
    tg.load_state_dict(weights.net_g_state_dict(g_vars, cfg["network_g"]),
                       strict=True)
    tg.eval()
    src, drv = _images(1, 60), _images(2, 61)
    with torch.no_grad():
        dm = me.eval()(_nchw(drv), _nchw(np.repeat(src, 2, axis=0)))
    jdm = {"deformation": jnp.asarray(dm["deformation"].numpy()),
           "occlusion_map": jnp.asarray(_nhwc(dm["occlusion_map"])),
           "driving_kp_heatmap": jnp.asarray(
               dm["driving_kp_heatmap"].numpy())}
    jg = jax_build(dict(cfg["network_g"]))
    ref = jax.jit(lambda v, s, m: jg.apply(v, s, m, inference=True))(
        g_vars, jnp.asarray(src), jdm)
    tdm = {key: dm[key] for key in jdm}
    with torch.no_grad():
        out = tg(_nchw(src), tdm, inference=True)
    np.testing.assert_allclose(_nhwc(out["out"]), np.asarray(ref["out"]),
                               atol=2e-4, rtol=2e-4)
    for got, want in zip(out["deformation_list"], ref["deformation_list"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=2e-4)
