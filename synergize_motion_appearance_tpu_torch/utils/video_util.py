"""Video reader and writer with the audio passed through (the reference's
utils/video_util.py:29-123; the port's copy of the JAX package's).

Frames are BGR uint8 and go through OpenCV; the writer muxes a source
video's audio with the ffmpeg binary when that is on the PATH (the
reference uses ffmpeg-python), and writes the video without audio when it
is not. Without OpenCV both raise a RuntimeError that names it.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from .misc import require


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoReader:
    """Iterates a video's BGR uint8 frames; ``fps``, ``width``,
    ``height`` and ``nb_frames`` from the container."""

    def __init__(self, video_path: str):
        cv2 = require("cv2", "VideoReader")
        self.video_path = video_path
        self.cap = cv2.VideoCapture(video_path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open {video_path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 25.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.nb_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def get_frame(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        return frame if ok else None

    def __iter__(self):
        while True:
            f = self.get_frame()
            if f is None:
                return
            yield f

    def __len__(self):
        return self.nb_frames

    def close(self):
        self.cap.release()


class VideoWriter:
    """Writes BGR uint8 frames to an mp4 (OpenCV's mp4v); at ``close`` the
    audio of ``audio_source`` is muxed in when ffmpeg is present
    (video_util.py:89-123)."""

    def __init__(self, video_save_path: str, height: int, width: int,
                 fps: float = 25.0, audio_source: Optional[str] = None):
        cv2 = require("cv2", "VideoWriter")
        self.path = video_save_path
        self.audio_source = audio_source if has_ffmpeg() else None
        os.makedirs(os.path.dirname(os.path.abspath(video_save_path)),
                    exist_ok=True)
        self._tmp = (video_save_path + ".noaudio.mp4"
                     if self.audio_source else video_save_path)
        self.writer = cv2.VideoWriter(
            self._tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
        if not self.writer.isOpened():
            raise IOError(f"cv2.VideoWriter failed for {self._tmp}")

    def write_frame(self, frame: np.ndarray):
        self.writer.write(frame)

    def close(self):
        self.writer.release()
        if self.audio_source:
            try:
                subprocess.run(
                    ["ffmpeg", "-y", "-i", self._tmp, "-i",
                     self.audio_source, "-map", "0:v", "-map", "1:a?",
                     "-c", "copy", self.path],
                    check=True, capture_output=True)
                os.remove(self._tmp)
            except subprocess.CalledProcessError:
                os.replace(self._tmp, self.path)
