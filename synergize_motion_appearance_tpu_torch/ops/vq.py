"""Vector quantization against a codebook prefix or range.

Counterpart of ``synergize_motion_appearance_tpu/ops/vq.py``
(``vq_nearest_indices``, ``vq_quantize``, ``vq_lookup``; reference
archs/vqgan_arch.py:33-111). Latents are channel-last (..., D), as there.
"""
from __future__ import annotations

from typing import Optional

import torch


def vq_nearest_indices(z_flat, codebook):
    """z_flat: (N, D); codebook: (K, D). Returns ((N,) int64 indices of the
    nearest entry, (N, K) float32 distances). Distances are
    z^2 + e^2 - 2 z.e in float32; a tie goes to the first index."""
    z32 = z_flat.float()
    e32 = codebook.float()
    d = ((z32 ** 2).sum(dim=1, keepdim=True) + (e32 ** 2).sum(dim=1)[None]
         - 2.0 * z32 @ e32.t())
    return torch.argmin(d, dim=1), d


def vq_quantize(z, codebook, beta: float = 0.25, start: int = 0,
                num: Optional[int] = None):
    """Quantize z (..., D) against codebook[start:start + num]. Returns
    (z_q with the straight-through gradient, the commit loss
    beta * mean((sg(z_q) - z)^2) + mean((z_q - sg(z))^2), stats)."""
    K, D = codebook.shape
    if num is None:
        num = K - start
    cb = codebook[start:start + num]
    shp = z.shape
    idx, d = vq_nearest_indices(z.reshape(-1, D), cb)
    z_q = cb[idx].to(z.dtype).reshape(shp)

    zf = z.float()
    zqf = z_q.float()
    loss = (beta * torch.mean((zqf.detach() - zf) ** 2)
            + torch.mean((zqf - zf.detach()) ** 2))
    z_q = z + (z_q - z).detach()

    # a scatter, not bincount, whose output size would need the host to
    # read max(idx) from the card
    counts = torch.zeros(num, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, device=idx.device)) / idx.numel()
    perplexity = torch.exp(-torch.sum(counts * torch.log(counts + 1e-10)))
    stats = {"perplexity": perplexity,
             "min_encoding_indices": idx.reshape(shp[:-1]),
             "mean_distance": d.mean()}
    return z_q, loss, stats


def vq_lookup(indices, codebook, shape=None):
    """Codebook rows by index (get_codebook_feat, vqgan_arch.py:99-111)."""
    z_q = codebook[indices.reshape(-1)]
    return z_q.reshape(shape) if shape is not None else z_q
