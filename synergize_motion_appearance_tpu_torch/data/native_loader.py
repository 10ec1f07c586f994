"""ctypes binding of the native frame-cache loader (the port's copy of the
JAX package's data/native_loader.py, over its own copy of the C++ source,
``native/framecache.cpp`` in this package).

``write_cache`` packs videos of uint8 RGB frames into one cache file;
``NativeFrameCacheLoader.next()`` yields {'source', 'driving'} float32 NHWC
batches made by C++ worker threads from the memory-mapped cache: a random
video, two sorted random frames, a shared horizontal flip and time flip,
normalized to [-1, 1]. Drawn from a counter-based generator seeded by
``seed``: with one worker thread the batch sequence is fixed by the seed.

The library is built at first use with ``g++ -O3 -fPIC -std=c++17 -pthread
-shared`` (no -march=native: a build may move to another machine) into
``build/native/`` beside the package, named by a hash of the source, the
flags, the machine type and the compiler's version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "framecache.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]
MAGIC = 0x31304346544D4153  # "SAMTFC01"

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the "
                           "native frame cache")
    return cxx


def library_path() -> Path:
    """Where the library of this source, these flags, this machine type
    and this compiler lives."""
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in [*CXX_FLAGS, platform.machine(), cxx, *version]:
        h.update(part.encode())
    return BUILD_DIR / f"libframecache-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library is up to date; returns the
    library's path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half
    return path


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with its signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.fc_open.restype = ctypes.c_void_p
    lib.fc_open.argtypes = [ctypes.c_char_p]
    lib.fc_close.argtypes = [ctypes.c_void_p]
    for fn in ("fc_num_videos", "fc_height", "fc_width", "fc_channels"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fc_num_frames.restype = ctypes.c_uint32
    lib.fc_num_frames.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.fc_get_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.fc_sampler_start.restype = ctypes.c_void_p
    lib.fc_sampler_start.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.fc_sampler_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.fc_sampler_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def write_cache(dst_path: str,
                videos: Iterable[Tuple[int, Iterator[np.ndarray]]],
                height: int, width: int, channels: int = 3) -> None:
    """Pack ``videos``, an iterable of (num_frames, frames) where frames
    yields uint8 (height, width, channels) RGB arrays, into the cache file
    ``dst_path``: the header (magic, video count, frame shape), one
    (payload offset, frame count) entry per video, then the frames."""
    metas = []
    frame_bytes = height * width * channels
    payload_path = dst_path + ".payload"
    offset = 0
    with open(payload_path, "wb") as pf:
        for num_frames, frames in videos:
            metas.append((offset, num_frames))
            for frame in frames:
                if frame.shape != (height, width, channels) or \
                        frame.dtype != np.uint8:
                    raise ValueError(
                        f"frame {frame.shape} {frame.dtype}, want "
                        f"{(height, width, channels)} uint8")
                pf.write(frame.tobytes())
            offset += num_frames * frame_bytes
    with open(dst_path, "wb") as f:
        f.write(struct.pack("<Q", MAGIC))
        f.write(struct.pack("<IIII", len(metas), height, width, channels))
        for off, nf in metas:
            f.write(struct.pack("<QI", off, nf))
        with open(payload_path, "rb") as pf:
            shutil.copyfileobj(pf, f, 1 << 24)
    os.remove(payload_path)


def cache_from_frame_tree(root: str, dst_path: str, size: int) -> int:
    """Pack every video folder under ``root`` (its frames as .png or
    .jpg, in name order) into the cache ``dst_path``, each frame resized
    to size x size, RGB (the JAX package's tools/build_framecache.py).
    Needs OpenCV. Returns the number of videos."""
    from ..utils.img_util import _cv2, imread

    cv2 = _cv2("building a frame cache")
    video_frames = []
    for vd in sorted(Path(root).iterdir()):
        if vd.is_dir():
            frames = sorted(vd.glob("*.png")) or sorted(vd.glob("*.jpg"))
            if frames:
                video_frames.append(frames)

    def frames_of(paths):
        for fp in paths:
            img = cv2.resize(imread(str(fp)), (size, size),
                             interpolation=cv2.INTER_LINEAR)
            yield np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB

    write_cache(dst_path, ((len(f), frames_of(f)) for f in video_frames),
                size, size, 3)
    return len(video_frames)


class NativeFrameCacheLoader:
    """Batches of (source, driving) pairs from a cache file, made by
    ``num_workers`` C++ threads (see the module docstring)."""

    def __init__(self, cache_path: str, batch_size: int,
                 num_workers: int = 4, seed: int = 0, hflip: bool = True,
                 time_flip: bool = True, mean: float = 0.5,
                 std: float = 0.5):
        self.lib = load_library()
        self.sampler = None
        self.handle = self.lib.fc_open(str(cache_path).encode())
        if not self.handle:
            raise IOError(f"failed to open frame cache {cache_path}")
        self.batch = batch_size
        self.h = self.lib.fc_height(self.handle)
        self.w = self.lib.fc_width(self.handle)
        self.c = self.lib.fc_channels(self.handle)
        self.sampler = self.lib.fc_sampler_start(
            self.handle, batch_size, num_workers, seed, int(hflip),
            int(time_flip), mean, std)

    @property
    def num_videos(self) -> int:
        return self.lib.fc_num_videos(self.handle)

    def next(self) -> Dict[str, np.ndarray]:
        """The next batch: (batch, H, W, C) float32 source and driving."""
        shape = (self.batch, self.h, self.w, self.c)
        src = np.empty(shape, np.float32)
        drv = np.empty(shape, np.float32)
        self.lib.fc_sampler_next(
            self.sampler, src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            drv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return {"source": src, "driving": drv}

    def get_frame(self, video: int, frame: int) -> np.ndarray:
        """One raw uint8 frame of the cache."""
        out = np.empty((self.h, self.w, self.c), np.uint8)
        self.lib.fc_get_frame(self.handle, video, frame,
                              out.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_uint8)))
        return out

    def close(self) -> None:
        """Stop the worker threads and unmap the cache."""
        if getattr(self, "sampler", None):
            self.lib.fc_sampler_stop(self.sampler)
            self.sampler = None
        if getattr(self, "handle", None):
            self.lib.fc_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
