"""Which kernel should serve six head widths: times, on the card, the
kernels that can take each width at the attention shapes of the flagship
generator (chip_smoke.attention_cases, one frame batch of FRAME_BATCH),
each launch held against the plain version first:

- at n_head 32, float32 d = 1 (the motion transformer's 16 launches): the
  CUDA-core d = 1 kernel attn_packed_kernel_chunked_f32<1, 1, float> of
  fused_attention_chunked.cu (what plan picks) and the CUDA-core
  attn_packed_kernel<4, R> of fused_attention_packed.cu, which zero-pads
  d to 4 (R = f32_rows);
- at n_head 32, bfloat16 d = 1 (the motion transformer's shapes in
  bfloat16, on no path): the d = 1 kernel in bfloat16 (what plan picks)
  and the d-chunked attn_packed_kernel_chunked_tc that served it before;
- at n_head 32, bfloat16 d = 8 (the appearance transformer's 16 launches):
  the mma.sync kernel (what plan picks) and the d-chunked
  attn_packed_kernel_chunked_tc;
- at n_head 1, bfloat16 d = 256 (the appearance transformer's 16
  launches): the d = 256 wgmma kernel of fused_attention_wgmma256.cu
  (what plan picks) and the d-chunked attn_packed_kernel_chunked_tc that
  served d = 256 before it;
- at n_head 1 and 2, float32 d = 256 and 128 (the appearance
  transformer's 16 launches in a float32 generator): the float32 wide
  kernel attn_packed_kernel_f32wide (what plan picks) and the d-chunked
  attn_packed_kernel_chunked_f32<16, 64> that served them before it.

Each kernel is forced through fused_attention_packed by replacing plan
for the call (chip_smoke.forced_kernel). Times are the profiler's device
time per call (chip_smoke.device_ms), summed over the frame batch's
launches of each half; the two kernels of a width are timed in turn,
twice (a, b, b, a), within one process. Prints the card's name and power
limit, one line per shape, and as its last line one JSON object of the
sums.

    python3 chip_attention_choice.py
"""
import json
import os
import sys
from collections import Counter

import torch

import chip_smoke as cs


def candidates(fa, dtype, B, H, L, d, sms):
    """The plans to time at one shape, plan's own first, then the kernel
    that served the width before it (float32 up to d = 64: the CUDA-core
    kernel of fused_attention_packed.cu; else the d-chunked kernel)."""
    picked = fa.plan(dtype, B, H, L, d, sms, 0, 0, 0, 0)
    if dtype == torch.float32 and d <= 64:
        return [picked, fa.Plan("f32", fa.f32_rows(B, H, L, d, sms))]
    return [picked, fa.Plan("chunked", fa.CHUNKED_ROWS[dtype])]


# (n_head, transformer half, dtype) of the widths compared
WIDTHS = [(32, "motion", torch.float32), (32, "motion", torch.bfloat16),
          (32, "app", torch.bfloat16), (1, "app", torch.bfloat16),
          (1, "app", torch.float32), (2, "app", torch.float32)]


def main():
    if not torch.cuda.is_available():
        print("chip_attention_choice: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, cs.ROOT)
    from synergize_motion_appearance_tpu_torch.ops import cuda_build
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    cuda_build.build("fused_attention_packed", "fused_attention_chunked",
                     "fused_attention_wgmma256")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(4321)
    sums, rows = {}, []
    cases = [(dtype, case) for H, half, dtype in WIDTHS
             for case in cs.attention_cases(cs.FRAME_BATCH, H=H)
             if case[0].startswith(half)]
    for dtype, (name, B, L, E, H, K, shared, with_bias, per) in cases:
        d = E // H
        plans = candidates(fa, dtype, B, H, L, d, sms)
        q = torch.randn(B, L, E, generator=gen, device="cuda").to(dtype)
        kv_shape = (K, E) if shared else (B, K, E)
        k = torch.randn(*kv_shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(*kv_shape, generator=gen, device="cuda").to(dtype)
        bias = cs.random_bias(torch, gen, B, K) if with_bias else None
        with torch.no_grad():
            ref = fa.fused_attention_packed_reference(q, k, v, bias,
                                                      num_heads=H)
            calls = {}
            for p in plans:
                call = cs.forced_kernel(fa, p, H)
                cs.assert_attention_close(torch, call(q, k, v, bias), ref,
                                          with_bias)
                calls[p.kernel] = lambda call=call: call(q, k, v, bias)
            ms = {kern: [] for kern in calls}
            for kern in list(calls) + list(calls)[::-1]:
                ms[kern].append(cs.device_ms(torch, calls[kern]))
        row = {"case": name, "n_head": H, "dtype": str(dtype).split(".")[1],
               "d": d, "launches_per_frame_batch": per,
               "picked": plans[0].kernel,
               "ms": {kern: min(t) for kern, t in ms.items()},
               "ms_runs": ms}
        rows.append(row)
        half = sums.setdefault(row["dtype"] + f"_d{d}", Counter())
        for kern, t in row["ms"].items():
            half[kern] += t * per
        print(f"{name:17s} {row['dtype']:8s} d {d}  "
              + "  ".join(f"{kern} {t:.4f} ms" for kern, t in
                          row["ms"].items())
              + f"  (plan: {row['picked']})", flush=True)
        del q, k, v, bias, ref
    out_dir = os.path.join(cs.ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_attention_choice.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f)
    print(json.dumps({"card": card, "sums_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
