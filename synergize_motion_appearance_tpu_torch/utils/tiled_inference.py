"""Tiled image-to-image inference (the reference's
utils/realesrgan_utils.py:14-253, RealESRGANer's pre-pad, mod-pad and tile
loop; the port's copy of the JAX package's utils/tiled_inference.py).

The image stays a host numpy array: each tile, with ``tile_pad`` pixels
of its neighbours, goes to ``device`` as a torch tensor, through ``fn``,
and back, and the tiles' inner parts are stitched on the host.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class TiledRestorer:
    def __init__(self, fn: Callable, scale: int = 1, tile_size: int = 0,
                 tile_pad: int = 10, pre_pad: int = 0, mod_pad: int = 1,
                 device="cuda"):
        """fn: a (B, h, w, C) torch tensor -> (B, h * scale, w * scale, C')
        (C' = C in the JAX package; tiles stitch into float32);
        ``tile_size`` 0 runs the whole image at once."""
        self.fn = fn
        self.scale = scale
        self.tile_size = tile_size
        self.tile_pad = tile_pad
        self.pre_pad = pre_pad
        self.mod_pad = mod_pad
        self.device = torch.device(device)

    def _run(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        with torch.no_grad():
            return self.fn(x).cpu().numpy()

    def _pad(self, img):
        h, w = img.shape[1:3]
        pre = self.pre_pad
        img = np.pad(img, ((0, 0), (pre, pre), (pre, pre), (0, 0)),
                     mode="reflect")
        m = self.mod_pad
        ph = (m - img.shape[1] % m) % m
        pw = (m - img.shape[2] % m) % m
        img = np.pad(img, ((0, 0), (0, ph), (0, pw), (0, 0)),
                     mode="reflect")
        return img, (h, w)

    def _tile_process(self, img):
        b, h, w, _ = img.shape
        s = self.scale
        out = None
        ts = self.tile_size
        for y0 in range(0, h, ts):
            for x0 in range(0, w, ts):
                y1 = min(y0 + ts, h)
                x1 = min(x0 + ts, w)
                yp0 = max(y0 - self.tile_pad, 0)
                xp0 = max(x0 - self.tile_pad, 0)
                yp1 = min(y1 + self.tile_pad, h)
                xp1 = min(x1 + self.tile_pad, w)
                tile_out = self._run(img[:, yp0:yp1, xp0:xp1])
                if out is None:  # fn's channels, which may differ from C
                    out = np.zeros((b, h * s, w * s, tile_out.shape[-1]),
                                   np.float32)
                oy0, ox0 = (y0 - yp0) * s, (x0 - xp0) * s
                out[:, y0 * s:y1 * s, x0 * s:x1 * s] = tile_out[
                    :, oy0:oy0 + (y1 - y0) * s, ox0:ox0 + (x1 - x0) * s]
        return out

    def enhance(self, img: np.ndarray) -> np.ndarray:
        """img: (B, H, W, C) float; returns (B, H * scale, W * scale, C)."""
        padded, (h, w) = self._pad(img)
        if self.tile_size > 0:
            out = self._tile_process(padded)
        else:
            out = self._run(padded)
        s = self.scale
        pre = self.pre_pad * s
        return out[:, pre:pre + h * s, pre:pre + w * s]
