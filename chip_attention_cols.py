"""Two checks of the wgmma attention designs' column count D (d rounded up
to 32, ops/fused_attention.py::wgmma_cols), on the card:

- with --parent DIR (a checkout of another tree of this repository): the
  SASS of the three wgmma attention libraries, built from both trees,
  kernel by kernel; the instantiations both trees hold (d = 16, 32, 64;
  d = D = 128 and 256 on 3-d maps) are compared instruction for
  instruction, register names and branch targets included;
- D rounded up to 64 in place of 32: the two wgmma sources built with
  that rounding (an nvcc of each under build/attention_cols/), checked
  against the plain version, then timed against plan's kernel at one
  appearance launch of a flagship frame batch at bf16 d = 96 and 160 (B
  16, L = K = 1024, the key bias on; the profiler's device time, in turns
  a, b, b, a). It rewrites one line of each source (PAD64), so it is a
  measurement of these sources as they are: PERF.md's pad-to-64 times
  come from it, and a later edit to either line removes this half and
  its test rather than follow the edit.

Prints the card's name and power limit, one line per comparison, and as
its last line one JSON object of the results.

    python3 chip_attention_cols.py [--parent DIR]
"""
import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import chip_smoke as cs

LIBS = ("fused_attention_wgmma", "fused_attention_wgmma128",
        "fused_attention_wgmma256")
# (library, the source's rounding of d to D, the same rounding to 64)
PAD64 = [("fused_attention_wgmma128", "d > 96 ? launch_d<128, true>",
          "true ? launch_d<128, true>"),
         ("fused_attention_wgmma256", "const int D = (d + 31) / 32 * 32;",
          "const int D = (d + 63) / 64 * 64;")]
PAD64_WIDTHS = [(192, 2), (320, 2)]  # (E, H) at d = 96 and 160


def functions(sass):
    """{kernel name: [instruction text]} from cuobjdump -sass output."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?);", line)
        if name and m:
            funcs[name].append(m.group(1).strip())
    return funcs


def instance(name):
    """A kernel's (template, arguments) with the 3-d-map instantiations of
    the column-count templates (<128 or 256, false, BIAS>) named as the
    templates without D and M4 named them (<BIAS>)."""
    m = re.search(r"(attn_packed_kernel_wgmma(?:128|256)?)I(.*?)EEv", name)
    return m.group(1), re.sub(r"^Li(128|256)ELb0ELb", "Lb", m.group(2))


def sass_of(root):
    """The three libraries' SASS as built from the tree at root (in a
    process of its own: each tree's package and build directory)."""
    code = ("import json, sys; sys.path.insert(0, '.'); from "
            "synergize_motion_appearance_tpu_torch.ops import cuda_build as c"
            "; c.build(*%r); print(json.dumps({n: c.sass(n) for n in %r}))"
            % (LIBS, LIBS))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.splitlines()[-1])


def compare_sass(parent):
    old, new = sass_of(parent), sass_of(cs.ROOT)
    rows = []
    for lib in LIBS:
        a = {instance(n): f for n, f in functions(old[lib]).items()}
        b = {instance(n): f for n, f in functions(new[lib]).items()}
        for key in sorted(set(a) & set(b)):
            same = a[key] == b[key]
            rows.append({"library": lib, "kernel": "".join(key),
                         "instructions": [len(a[key]), len(b[key])],
                         "identical": same})
            print(f"SASS {lib} {''.join(key)}: {len(a[key])} / "
                  f"{len(b[key])} instructions, identical {same}",
                  flush=True)
    return rows


def build_pad64():
    from synergize_motion_appearance_tpu_torch.ops import cuda_build

    out = os.path.join(cs.ROOT, "build", "attention_cols")
    os.makedirs(out, exist_ok=True)
    libs = {}
    for lib, old, new in PAD64:
        with open(os.path.join(cuda_build.CSRC, lib + ".cu")) as f:
            src = f.read()
        assert src.count(old) == 1, (lib, old)
        path = os.path.join(out, lib + ".cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        so = os.path.join(out, lib + ".so")
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(cuda_build.CSRC), "-o", so, path], check=True,
                       capture_output=True)
        libs[lib] = ctypes.CDLL(so)
    return libs


def pad64_times(torch, fa, libs):
    gen = torch.Generator(device="cuda").manual_seed(5678)
    rows = []
    for E, H in PAD64_WIDTHS:
        B, L, K, d = cs.FRAME_BATCH, 1024, 1024, E // H
        q, k, v = (torch.randn(B, n, E, generator=gen, device="cuda").to(
            torch.bfloat16) for n in (L, K, K))
        bias = cs.random_bias(torch, gen, B, K)
        name = "wgmma128" if d <= 128 else "wgmma256"
        fn = getattr(libs[f"fused_attention_{name}"],
                     f"samt_attention_{name}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]

        def pad64():
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), B, H, L, K, d, 0, 0,
                     1 / math.sqrt(d),
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"pad-to-64 launch failed with {err}"
            return out

        def planned():
            return fa.fused_attention_packed(q, k, v, bias, num_heads=H)

        with torch.no_grad():
            ref = fa.fused_attention_packed_reference(q, k, v, bias,
                                                      num_heads=H)
            for f in (pad64, planned):
                cs.assert_attention_close(torch, f(), ref, True)
            turns = [cs.device_ms(torch, f)
                     for f in (planned, pad64, pad64, planned)]
        row = {"d": d, "D": fa.wgmma_cols(d), "D_pad64": -(-d // 64) * 64,
               "device_ms_turns": turns,
               "pad64_over_kernel": (turns[1] + turns[2])
               / (turns[0] + turns[3])}
        rows.append(row)
        print(f"bf16 d {d}: D = {row['D']} " + " / ".join(
            f"{t:.4f}" for t in turns) + f" ms (planned, D = "
            f"{row['D_pad64']}, D = {row['D_pad64']}, planned): "
            f"{row['pad64_over_kernel']:.3f}x", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_attention_cols: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, cs.ROOT)
    from synergize_motion_appearance_tpu_torch.ops import fused_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    result = {"card": card}
    if args.parent:
        result["sass"] = compare_sass(args.parent)
    result["pad64"] = pad64_times(torch, fa, build_pad64())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
