"""Where a tier-1 run's time goes, per test file, even when the run's clock
cuts it (a cut run writes no junitxml and prints no --durations).

As a pytest plugin it appends one JSON line per test start and end, with
the xdist worker, to $SAMT_FILE_TIMES (default file_times.jsonl):

    PYTHONPATH=tests SAMT_FILE_TIMES=/tmp/times.jsonl python -m pytest \\
        tests/ -p _file_times -n 6 --dist loadfile ...

Run as a script it prints each file's wall span on its worker, slowest
first, and each worker's last end, in seconds from the first test start:

    python tests/_file_times.py /tmp/times.jsonl [N]
"""
import json
import os
import sys
import time
from collections import defaultdict

PATH = os.environ.get("SAMT_FILE_TIMES", "file_times.jsonl")


def _write(event, nodeid):
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker is None:  # the controller relays the workers' events
        return
    with open(PATH, "a") as f:
        f.write(json.dumps({"ev": event, "id": nodeid, "t": time.time(),
                            "w": worker}) + "\n")


def pytest_runtest_logstart(nodeid, location):
    _write("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _write("end", nodeid)


def summary(path, top=40):
    events = [json.loads(line) for line in open(path)]
    t0 = min(e["t"] for e in events)
    now = max(e["t"] for e in events)
    files = defaultdict(lambda: {"start": None, "end": None, "open": 0,
                                 "done": 0})
    for e in events:
        f = files[e["id"].split("::")[0]]
        f["w"] = e["w"]
        if e["ev"] == "start":
            f["start"] = e["t"] if f["start"] is None else f["start"]
            f["open"] += 1
        else:
            f["end"] = e["t"]
            f["open"] -= 1
            f["done"] += 1
    rows = sorted(((((f["end"] if not f["open"] else now) - f["start"]),
                    name, f) for name, f in files.items()), reverse=True)
    print(f"{len(rows)} files, {sum(r[0] for r in rows):.0f} worker-s, "
          f"span {now - t0:.0f} s")
    for span, name, f in rows[:top]:
        print(f"{span:7.1f} s {name:52s} {f['w']} {f['done']} tests "
              f"[{f['start'] - t0:.0f}-{span + f['start'] - t0:.0f}]"
              + (" cut" if f["open"] else ""))
    last = defaultdict(float)
    for span, _, f in rows:
        last[f["w"]] = max(last[f["w"]], f["start"] - t0 + span)
    print(" ".join(f"{w}:{s:.0f}" for w, s in sorted(last.items())))


if __name__ == "__main__":
    summary(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 40)
