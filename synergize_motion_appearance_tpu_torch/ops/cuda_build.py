"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/cuda/<name>-<hash>.so`` beside the
package, where ``<hash>`` covers every file under ``csrc/`` and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ``ctypes``. nvcc's output, with ptxas's registers,
shared memory and spills of every kernel (``-Xptxas -v``), is kept beside
it as ``<name>-<hash>.log`` (``build_log``), and ``sass`` disassembles the
library with the toolkit's ``cuobjdump``. Nothing is compiled when the package is
imported: only when a kernel is first launched, or when ``build`` is
called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc(tool: str = "nvcc") -> str:
    found = shutil.which(tool)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / tool
    if not path.exists():
        raise RuntimeError(
            f"{tool} not found (not on PATH, nor under $CUDA_HOME or "
            f"/usr/local/cuda)")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> float:
    """Compile csrc/<name>.cu for each name whose library is not up to
    date, one nvcc process per source, all started together; returns the
    seconds until the last one finished (0.0 when nothing was built)."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            _library_path(name).with_suffix(".log").write_text(out)
            # atomic: a concurrent build never sees half a file
            os.replace(tmp, _library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas's per-kernel report) of csrc/<name>.cu's
    build, building it first if needed."""
    build(name)
    return _library_path(name).with_suffix(".log").read_text()


def sass(name: str) -> str:
    """The SASS of csrc/<name>.cu's library, by ``cuobjdump -sass``."""
    build(name)
    return subprocess.run([_nvcc("cuobjdump"), "-sass",
                           str(_library_path(name))], check=True,
                          capture_output=True, text=True).stdout
