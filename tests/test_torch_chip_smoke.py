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
