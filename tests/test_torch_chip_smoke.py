"""chip_smoke.py's report clock, on the CPU: each phase's wall time is
the time between the report key it sets and the key set before it."""
import chip_smoke


def test_phase_clock_times_each_key_from_the_one_before(monkeypatch):
    clock = iter([10.0, 10.5, 13.0, 13.25])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(clock))
    report = chip_smoke.PhaseClock(card="H100", build_s=1.0)
    report["k1_cases"] = [1]
    report["main_path"], run = {"frames": 64}, None
    report["kernels"] = []
    assert report.seconds == {"k1_cases": 0.5, "main_path": 2.5,
                              "kernels": 0.25}
    assert report == {"card": "H100", "build_s": 1.0, "k1_cases": [1],
                      "main_path": {"frames": 64}, "kernels": []}


def test_kernel_entry_of_a_float32_only_kernel():
    """kernel_entry for a kernel with float32 cases only (the float32
    wide kernel): max_abs_err over them, and times summed per call with
    weight "calls" over the cases ``summed`` picks (the d-chunked
    kernels' ragged shapes, one call each)."""
    def row(d, err, ms, calls=1, timed=True):
        r = {"dtype": "float32", "d": d, "max_abs_err": err, "calls": calls}
        if timed:
            r.update(ms=ms, plain_ms=10 * ms, library_ms=ms / 2,
                     device_ms=ms, library_device_ms=ms / 2,
                     bound_ms=ms / 4, bound_by="operations")
        return r

    rows = [row(256, 1e-6, 0.5), row(320, 3e-6, 1.0),
            row(96, 2e-6, None, timed=False)]
    got = chip_smoke.kernel_entry("k", "a.cu", "b.py:1", rows, "calls", 0,
                                  "note", summed=lambda r: "ms" in r)
    assert got["max_abs_err"] == 3e-6 and "max_abs_err_f32" not in got
    assert got["ms"] == 1.5 and got["plain_ms"] == 15.0
    assert got["library_ms"] == 0.75 and got["device_ms"] == 1.5
    assert got["bound_ms"] == 0.375 and got["bound_by"] == "operations"
    assert got["launches"] == 0


def test_guards_hold_the_new_kernels():
    """The speed guards name the float32 wide kernel's float32 d = 256
    sum and the d = 1 kernel's bf16 sum, beside the earlier six, and the
    five TIMED_WIDTHS instantiations' device times."""
    names = [(name, key) for name, key, _ in chip_smoke.PREVIOUS_MS]
    assert ("fused_attention_packed (f32 wide)", "device_ms") in names
    assert ("fused_attention_packed (d = 1)", "device_ms_bf16") in names
    for name, _, _, _ in chip_smoke.TIMED_ENTRIES:
        assert (name, "device_ms") in names
    assert len(names) == 13 == len(set(names))


def _source_instantiations(cuda_build):
    """{(plan kernel, D, W or C, M4)}: the instantiations that the C entries
    of the d = 128 and d = 256 wgmma designs (launch_d<D, M4>), of the
    d = 512 one (launch_w<W>, M4 None) and of the float32 wide kernel
    (launch_wide<C>, M4 None) launch, read from their sources."""
    import re

    found = set()
    for kernel in ("wgmma128", "wgmma256"):
        src = (cuda_build.CSRC / f"fused_attention_{kernel}.cu").read_text()
        found |= {(kernel, int(D), m4 == "true") for D, m4 in re.findall(
            r"launch_d<(\d+), (true|false)>\(", src)}
    src = (cuda_build.CSRC / "fused_attention_wgmma512.cu").read_text()
    found |= {("wgmma512", int(W), None)
              for W in re.findall(r"launch_w<(\d+)>\(", src)}
    src = (cuda_build.CSRC / "fused_attention_chunked.cu").read_text()
    found |= {("f32wide", int(C), None)
              for C in re.findall(r"launch_wide<(\d+)>\(", src)}
    return found


def test_ragged_widths_reach_each_wide_kernel():
    """RAGGED_WIDTHS, at aligned pointers, run the float32 wide kernel
    (float32 d = 72 to 1024), the d = 128, d = 256 and d = 512 wgmma
    designs (bf16 d = 72, 96, 112, 128; 160, 224, 248, 256; 264, 288,
    320, 384, 448, 504, 512) and the d-chunked kernels (bf16 d = 161, off
    d % 8 = 0, and 520 to 1032, past 512; float32 d = 1032, past the wide
    kernel), so the d-chunked kernels, on no frame batch, are checked and
    timed there; TIMED_WIDTHS run the wgmma designs at D = 96 and 192 and
    W = 192, and the wide kernel at C = 384 and 640. Together they reach
    every instantiation that the sources' C entries launch: each (D, M4)
    of the d = 128 and d = 256 wgmma designs (M4 at every d but the
    design's own 128 or 256), each W of the d = 512 one and each C of the
    wide kernel."""
    import pytest

    torch = pytest.importorskip("torch")
    from synergize_motion_appearance_tpu_torch.ops import (
        cuda_build,
        fused_attention as fa,
    )

    def instance(kernel, d):
        if kernel == "f32wide":
            return kernel, fa.f32wide_cols(d), None
        if kernel == "wgmma512":
            return kernel, fa.wgmma512_part(d), None
        return kernel, fa.wgmma_cols(d), d != int(kernel[5:])

    got, reached = {}, set()
    for name, B, L, E, H, K, _, _, _ in chip_smoke.RAGGED_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            kernel = fa.plan(dtype, B, H, L, E // H, 132, 0, 0, 0, 0).kernel
            got.setdefault(kernel, set()).add(
                (str(dtype).split(".")[1], E // H))
            if kernel != "chunked":
                reached.add(instance(kernel, E // H))
    assert got == {
        "f32wide": {("float32", d) for d in (
            72, 96, 112, 128, 160, 161, 224, 248, 256, 264, 288, 320, 384,
            448, 504, 512, 520, 640, 712, 776, 1024)},
        "wgmma128": {("bfloat16", d) for d in (72, 96, 112, 128)},
        "wgmma256": {("bfloat16", d) for d in (160, 224, 248, 256)},
        "wgmma512": {("bfloat16", d) for d in (264, 288, 320, 384, 448, 504,
                                               512)},
        "chunked": {("bfloat16", d) for d in (161, 520, 640, 712, 776, 1024,
                                              1032)}
        | {("float32", 1032)}}
    timed = {(dtype, E // H, fa.plan(getattr(torch, dtype), B, H, L, E // H,
                                     132, 0, 0, 0, 0).kernel)
             for _, B, L, E, H, K, _, _, dtype in chip_smoke.TIMED_WIDTHS}
    assert timed == {("bfloat16", 96, "wgmma128"),
                     ("bfloat16", 192, "wgmma256"),
                     ("float32", 320, "f32wide"),
                     ("bfloat16", 384, "wgmma512"),
                     ("float32", 640, "f32wide")}
    assert [fa.wgmma_cols(96), fa.wgmma_cols(192), fa.f32wide_cols(320),
            fa.wgmma512_part(384), fa.f32wide_cols(640)] == [
        96, 192, 384, 192, 640]
    reached |= {instance(kernel, d) for _, d, kernel in timed}
    assert reached == _source_instantiations(cuda_build)
    # 3 + 5 wgmma (D, M4), 4 d = 512 design W, 8 wide C
    assert len(reached) == 20


def _widths_report(torch, fa):
    """A report shaped as attention_widths_phase returns it (string keys),
    with each row's kernel from plan and made-up times: K1 and K2 rows at
    n_head 1, 2 and 32 and at RAGGED_WIDTHS, timed as the phase times
    them, and the frame batches' kernel counts."""
    def rows(cases, weight, split):
        out = []
        for name, B, L, E, H, K, _, _, per in cases:
            d = E // H
            path = "float32" if name.startswith("motion") else "bfloat16"
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).split(".")[1]
                kernel = fa.plan(dtype, B, H, L, d, 132, 0, 0, 0, 0).kernel
                r = {"case": name, "dtype": dt, "d": d, "kernel": kernel,
                     weight: per, "max_abs_err": 1e-6 * d}
                if split:
                    timed = per and (dt == "bfloat16" or d > 64 or d == 1)
                else:
                    r.update(calls=1, on_path=bool(per) and dt == path)
                    timed = ((per or kernel == "chunked")
                             and (dt == "bfloat16" or r["on_path"]
                                  or not per or d > 64))
                if timed:
                    r.update(ms=0.2, plain_ms=2.0, library_ms=0.1,
                             device_ms=0.1, library_device_ms=0.05,
                             bound_ms=0.05, bound_by="operations")
                out.append(r)
        return out

    report = {"k1": {}, "k2": {}, "halves": {}, "frame_batches": {}}
    for H in chip_smoke.HEAD_COUNTS:
        cases = chip_smoke.attention_cases(chip_smoke.FRAME_BATCH, H=H)
        k1 = rows(cases, "launches_per_frame_batch", False)
        k2 = rows(cases, "k1_launches_per_frame_batch", True)
        report["k1"][str(H)], report["k2"][str(H)] = k1, k2
        report["halves"][str(H)] = {
            "k1": chip_smoke.width_halves(k1),
            "k2": chip_smoke.width_halves(k2, "k1_launches_per_frame_batch")}
        report["frame_batches"][str(H)] = {"k1_kernels": dict(
            chip_smoke.head_width_kernels(torch, fa, H, 132))}
    report["k1"]["ragged"] = rows(chip_smoke.RAGGED_WIDTHS,
                                  "launches_per_frame_batch", False)
    report["k2"]["ragged"] = rows(chip_smoke.RAGGED_WIDTHS,
                                  "k1_launches_per_frame_batch", True)
    report["frame_batch_float32"] = {"k1_kernels": {"f32": 16,
                                                    "f32wide": 16}}
    report["frame_batch_app_d96"] = {"k1_kernels": dict(
        chip_smoke.head_width_kernels(torch, fa, 2, 132, E_app=192))}
    report["tiny_d320"] = {"k1_kernels": {"f32": 12, "f32wide": 12}}
    report["frame_batch_app_d384"] = {"k1_kernels": dict(
        chip_smoke.head_width_kernels(torch, fa, 1, 132, E_app=384))}
    report["tiny_d640"] = {"k1_kernels": {"f32": 12, "f32wide": 12}}
    report["timed"] = []
    for name, B, L, E, H, K, _, _, dtype in chip_smoke.TIMED_WIDTHS:
        kernel = fa.plan(getattr(torch, dtype), B, H, L, E // H, 132, 0, 0,
                         0, 0).kernel
        report["timed"].append({
            "case": name, "dtype": dtype, "B": B, "L": L, "K": K, "E": E,
            "H": H, "d": E // H, "kernel": kernel, "calls": 1,
            "max_abs_err": 1e-6, "max_abs_err_chunked": 2e-6,
            "max_abs_err_k2": 3e-6, "ms": 0.3, "plain_ms": 3.0,
            "library_ms": 0.2, "device_ms": 0.1, "library_device_ms": 0.15,
            "device_ms_turns": [0.1, 0.5, 0.5, 0.1], "chunked_device_ms": 0.5,
            "chunked_over_kernel": 5.0, "device_ms_k2": 0.1,
            "bound_ms": 0.05, "bound_by": "operations", "bound_share": 0.5})
    return report


def test_width_kernel_entries_from_the_phase_report():
    """width_kernel_entries builds the d-chunked, float32 wide, d = 1,
    d = 128 and d = 256 wgmma entries of the kernels line from the
    attention_widths report: each with the contract's keys, its launches
    on the phase's frame batches (the d-chunked kernels on none), its
    times summed over its frame batch's 16 launches (the d-chunked
    kernels' over one call at each ragged shape they run), and the keys
    the speed guards read."""
    import pytest

    torch = pytest.importorskip("torch")
    from synergize_motion_appearance_tpu_torch.ops import (
        fused_attention as fa,
    )

    entries = {e["name"]: e for e in chip_smoke.width_kernel_entries(
        _widths_report(torch, fa))}
    assert list(entries) == [
        "fused_attention_packed (d-chunked)",
        "fused_attention_packed (f32 wide)",
        "fused_attention_packed (d = 1)",
        "fused_attention_packed (wgmma d = 128)",
        "fused_attention_packed (wgmma d = 256)",
        "fused_attention_packed (wgmma d = 96)",
        "fused_attention_packed (wgmma d = 192)",
        "fused_attention_packed (f32 wide d = 320)",
        "fused_attention_packed (wgmma d = 384)",
        "fused_attention_packed (f32 wide d = 640)"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries.values():
        assert keys <= set(e), e["name"]
    launches = {name: e["launches"] for name, e in entries.items()}
    assert launches == {"fused_attention_packed (d-chunked)": 0,
                        "fused_attention_packed (f32 wide)": 16,
                        "fused_attention_packed (d = 1)": 16,
                        "fused_attention_packed (wgmma d = 128)": 16,
                        "fused_attention_packed (wgmma d = 256)": 16,
                        "fused_attention_packed (wgmma d = 96)": 16,
                        "fused_attention_packed (wgmma d = 192)": 0,
                        "fused_attention_packed (f32 wide d = 320)": 12,
                        "fused_attention_packed (wgmma d = 384)": 16,
                        "fused_attention_packed (f32 wide d = 640)": 12}
    # the ragged bf16 d = 161 and 520 to 1032 and float32 d = 1032, one
    # call each, named in the entry's note
    chunked = entries["fused_attention_packed (d-chunked)"]
    assert chunked["ms"] == pytest.approx(8 * 0.2)
    assert ("(bfloat16 d = 161, 520, 640, 712, 776, 1024 and 1032, float32 "
            "d = 1032;" in chunked["times_are"])
    for name, _, d, _ in chip_smoke.TIMED_ENTRIES:
        e = entries[name]
        assert e["ms"] == 0.3 and e["device_ms"] == 0.1
        assert e["chunked_device_ms"] == 0.5 and e["device_ms_k2"] == 0.1
        assert e["launches_note"]
    wide = entries["fused_attention_packed (f32 wide)"]
    assert wide["device_ms"] == pytest.approx(16 * 0.1)
    assert wide["device_ms_d128"] == pytest.approx(16 * 0.1)
    assert wide["device_ms_k2"] == pytest.approx(16 * 0.1)
    assert wide["max_abs_err"] == pytest.approx(1024e-6)  # ragged 1024
    assert ("ragged float32 d = 72, 96, 112, 128, 160, 161, 224, 248, 256, "
            "264, 288, 320, 384, 448, 504, 512, 520, 640, 712, 776 and 1024 "
            "cases" in wide["times_are"])
    for width in (128, 256):
        wg = entries[f"fused_attention_packed (wgmma d = {width})"]
        assert wg["device_ms"] == pytest.approx(16 * 0.1)
        assert wg["device_ms_k2"] == pytest.approx(16 * 0.1)
        assert wg["max_abs_err"] == pytest.approx(width * 1e-6)
    d1 = entries["fused_attention_packed (d = 1)"]
    assert d1["device_ms"] == pytest.approx(1.6)
    assert d1["device_ms_bf16"] == pytest.approx(1.6)
    for name, key, _ in chip_smoke.PREVIOUS_MS:
        if name in entries:
            assert key in entries[name], (name, key)


def _fake_widths_ranks(outcomes, calls):
    """A run_ranks that plays ``outcomes`` in turn for attention_widths:
    "ok" writes a report, "lost" writes the profiler-loss note and fails,
    "fail" fails without one."""
    import json

    def run_ranks(fn, world, args, timeout):
        out_path = args[0]
        outcome = outcomes[len(calls)]
        calls.append(outcome)
        if outcome == "ok":
            with open(out_path, "w") as f:
                json.dump({"seconds": 1.0}, f)
            return
        if outcome == "lost":
            with open(out_path + ".lost", "w") as f:
                f.write(chip_smoke.PROFILER_LOST + " in 3 sessions")
        raise AssertionError("ranks exited with [1]")
    return run_ranks


def test_widths_phase_reruns_once_after_a_profiler_loss(monkeypatch,
                                                        tmp_path):
    """attention_widths_phase runs the phase once more in a fresh process
    when the first process's profiler lost device activity, and returns
    that run's report."""
    calls = []
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "run_ranks",
                        _fake_widths_ranks(["lost", "ok"], calls))
    assert chip_smoke.attention_widths_phase(0, "card") == {"seconds": 1.0}
    assert calls == ["lost", "ok"]
    assert not (tmp_path / "build" / "chip_smoke_widths").exists()


def test_widths_phase_fails_on_other_faults_and_a_second_loss(monkeypatch,
                                                              tmp_path):
    """Any failure but a profiler loss fails the phase at once, and so
    does a second loss."""
    import pytest

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    for outcomes, ran in ((["fail", "ok"], ["fail"]),
                          (["lost", "lost", "ok"], ["lost", "lost"])):
        calls = []
        monkeypatch.setattr(chip_smoke, "run_ranks",
                            _fake_widths_ranks(outcomes, calls))
        with pytest.raises(AssertionError, match="ranks exited"):
            chip_smoke.attention_widths_phase(0, "card")
        assert calls == ran
