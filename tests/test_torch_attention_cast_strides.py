"""K1 and K2 take what the JAX package's functions take, on the CPU.

- A bias of another float dtype: the JAX functions cast it to float32
  (``bias.astype(jnp.float32)``, its ops/fused_attention.py:126, 290);
  the port's wrappers cast it before the op, so a bf16 bias gives the
  float32 bias's output through both layouts, and the op (and on a card
  ``_check_cuda``, which takes float32 only) never sees another dtype.
- Inputs of any strides: a JAX array has none, so the natural head-split
  view of token-major tensors, ``x.view(B, L, H, d).transpose(1, 2)``,
  is a valid input. The CUDA launch copies such inputs to contiguous
  ones before it reads their pointers (as the conv ops' launches do), so
  ``_check_cuda`` and the op's fake take them, and the output is the
  contiguous call's.

Nothing here imports JAX: the comparisons are between calls of the port.
"""
import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention as port,
)
from _torch_threads import two_torch_threads  # noqa: E402,F401


def _inputs(B, L, K, E, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (2 * torch.randn(B, n, E, generator=gen) for n in (L, K, K))
    drop = torch.rand(B, K, generator=gen) < 0.3
    drop[0] = True
    bias = torch.where(drop, -1e30, 0.0)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias


def _heads(t, H):
    B, n, E = t.shape
    return t.view(B, n, H, E // H).transpose(1, 2)


def _fake_cuda(mode, *tensors):
    """Fake tensors on a CUDA device, as torch.export traces them: no data
    and no card needed."""
    from torch._subclasses.fake_tensor import FakeTensor

    return [FakeTensor(mode, t.to("meta"), torch.device("cuda"))
            for t in tensors]


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float16,
                                        torch.float64], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_of_another_dtype_gives_the_float32_biass_output(dtype,
                                                             bias_dtype):
    H = 2
    q, k, v, bias = _inputs(2, 20, 33, 64, seed=3, dtype=dtype)
    other = bias.to(bias_dtype)
    want = port.fused_attention_packed(q, k, v, other.float(), num_heads=H)
    got = port.fused_attention_packed(q, k, v, other, num_heads=H)
    assert torch.equal(got, want)
    assert got[0].abs().max().item() == 0.0, "all-masked batch row"
    qh, kh, vh = (_heads(t, H).contiguous() for t in (q, k, v))
    assert torch.equal(port.fused_attention(qh, kh, vh, other),
                       port.fused_attention(qh, kh, vh, other.float()))


def test_the_ops_see_a_float32_bias_only(monkeypatch):
    """Both wrappers hand the op (whose CUDA kernel, and fake, run
    ``_check_cuda``) a float32 bias."""
    seen = []
    real = port._check_cuda

    def check(q, k, v, bias, num_heads):
        seen.append(None if bias is None else bias.dtype)
        return real(q, k, v, bias, num_heads)

    monkeypatch.setattr(port, "_check_cuda", check)
    q, k, v, bias = _inputs(2, 8, 16, 32, seed=4)
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    fq, fk, fv, fb = _fake_cuda(mode, q, k, v, bias.bfloat16())
    with mode:
        port.fused_attention_packed(fq, fk, fv, fb, num_heads=2)
        port.fused_attention(*(_heads(t, 2) for t in (fq, fk, fv)), fb)
    assert seen == [torch.float32, torch.float32]


def test_check_cuda_takes_any_strides_and_refuses_other_bias_dtypes():
    """_check_cuda no longer refuses a non-contiguous input (the launch
    copies it); it still refuses a bias the kernels cannot read."""
    q, k, v, bias = _inputs(2, 12, 20, 64, seed=5)
    qh, kh, vh = (_heads(t, 4) for t in (q, k, v))
    assert not qh.is_contiguous()
    assert port._check_cuda(qh, kh, vh, bias, None) == (2, 4, 12, 20, 16)
    assert port._check_cuda(q[:, ::2], k, v, bias, 4)[2] == 6
    with pytest.raises(TypeError, match="bias must be float32"):
        port._check_cuda(qh, kh, vh, bias.bfloat16(), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
def test_transposed_head_split_input_gives_the_contiguous_output(dtype,
                                                                 shared):
    H = 4
    q, k, v, bias = _inputs(3, 17, 24, 64, seed=6, dtype=dtype)
    if shared:
        k, v = k[:1], v[:1]
    qh, kh, vh = (_heads(t, H) for t in (q, k, v))
    assert not qh.is_contiguous() and not kh.is_contiguous()
    got = port.fused_attention(qh, kh, vh, bias)
    want = port.fused_attention(qh.contiguous(), kh.contiguous(),
                                vh.contiguous(), bias)
    assert torch.equal(got, want)
    assert got.is_contiguous()
    # and the same attention in the token-major layout, on a strided q
    wide = torch.cat([q, q], dim=-1)[..., :q.shape[-1]]
    assert not wide.is_contiguous()
    kt, vt = (k[0], v[0]) if shared else (k, v)
    packed = port.fused_attention_packed(wide, kt, vt, bias, num_heads=H)
    assert torch.equal(packed, port.fused_attention_packed(
        q, kt, vt, bias, num_heads=H))
    assert torch.equal(packed.view(3, 17, H, 16).transpose(1, 2), got)


def test_fakes_take_transposed_inputs():
    """The ops' fake implementations, which torch.export runs, accept the
    strided head-split view on a CUDA device (fake tensors: no card) and
    give a contiguous output of q's shape."""
    q, k, v, bias = _inputs(2, 16, 24, 64, seed=7, dtype=torch.bfloat16)
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    fq, fk, fv, fb, wide = _fake_cuda(mode, q, k, v, bias,
                                      torch.cat([q, q], dim=-1))
    with mode:
        out = torch.ops.samt.fused_attention(
            *(_heads(t, 4) for t in (fq, fk, fv)), fb)
        strided = wide.narrow(-1, 0, 64)
        assert not strided.is_contiguous()
        packed = torch.ops.samt.fused_attention_packed(strided, fk, fv, fb,
                                                       4)
    assert tuple(out.shape) == (2, 4, 16, 16) and out.is_contiguous()
    assert tuple(packed.shape) == (2, 16, 64) and packed.is_contiguous()
