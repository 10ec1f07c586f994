"""Profiling hooks on torch.profiler (the port's counterpart of the JAX
package's utils/profiler.py, which traces with jax.profiler; the reference
times only the training loop's iterations).

- ``trace(logdir)``: a torch.profiler session over the block, CPU activity
  and, where a CUDA card is present, the card's kernels and copies, written
  as a Chrome trace (``<host>.<pid>.<ns>.pt.trace.json``) under ``logdir``
  on exit; viewable in Perfetto or chrome://tracing.
- ``annotate(name)``: a named range in that trace
  (torch.profiler.record_function).
- ``StepTimer``: data and step wall time and their moving averages, as the
  reference's training loop reports them (train.py:175-199); the step
  ends once the devices of the tensors given are done.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, with the card's activity where a card is
    present. Yields the torch.profiler.profile."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                f".pt.trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _cuda_devices(tree, out):
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Data and step wall time, with exponential moving averages of decay
    ``ema``."""

    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.data_time = 0.0
        self.step_time = 0.0
        self._avg_data: Optional[float] = None
        self._avg_step: Optional[float] = None
        self._t = time.perf_counter()

    def mark_data(self):
        now = time.perf_counter()
        self.data_time = now - self._t
        self._t = now

    def mark_step(self, block_on=None):
        """End a step; first wait for every CUDA device that holds a tensor
        of ``block_on`` (a tensor, or lists, tuples and dicts of them)."""
        for device in _cuda_devices(block_on, set()):
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.step_time = now - self._t
        self._t = now
        for attr, v in (("_avg_data", self.data_time),
                        ("_avg_step", self.step_time)):
            prev = getattr(self, attr)
            setattr(self, attr, v if prev is None
                    else self.ema * prev + (1 - self.ema) * v)

    def summary(self) -> Dict[str, float]:
        return {
            "time": self._avg_step or self.step_time,
            "data_time": self._avg_data or self.data_time,
        }
