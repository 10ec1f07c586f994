"""Codebook cross-attention transformer layer.

Counterpart of the JAX package's models/transformer.py (reference
TransformerLayer, appmotioncodebook_arch.py:65-126): pre-LN self-attention
with the position embedding on q and k, cross-attention against codebook
entries (k = v = context, position only on q), and a conv FFN (3x3 convs
over the token grid, exact GELU). Batch-first (B, L, E) tokens.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_attention as fa


class MultiheadAttention(nn.Module):
    """Parameters as torch's nn.MultiheadAttention (packed in_proj_weight
    (3E, E) and in_proj_bias, out_proj Linear); the attention itself is
    the head-packed fused kernel."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None):
        """q: (B, Lq, E); k, v: (B, Lk, E), or (Lk, E) for a context shared
        by the batch (projected once; the kernel reads the one copy);
        key_padding_mask: (B, Lk) bool, True = exclude the key."""
        E = self.embed_dim
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(q, w[:E], b[:E])
        kp = F.linear(k, w[E:2 * E], b[E:2 * E])
        vp = F.linear(v, w[2 * E:], b[2 * E:])
        bias = None
        if key_padding_mask is not None:
            bias = torch.where(key_padding_mask, -1e30, 0.0).to(torch.float32)
        out = fa.fused_attention_packed(qp, kp, vp, bias,
                                        num_heads=self.num_heads)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, nhead: int = 8, dim_conv: int = 64):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, nhead)
        self.cross_attn = MultiheadAttention(embed_dim, nhead)
        self.conv1 = nn.Conv2d(embed_dim, dim_conv, 3, padding=1)
        self.conv2 = nn.Conv2d(dim_conv, embed_dim, 3, padding=1)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim)

    def forward(self, tgt, context, hw, key_padding_mask=None,
                query_pos=None):
        """tgt: (B, L, E); context: (B, K, E) or (K, E) shared; hw: (h, w)
        with h * w == L."""
        h, w = hw
        B, L, E = tgt.shape

        def with_pos(t):
            return t if query_pos is None else t + query_pos

        tgt2 = self.norm1(tgt)
        q = with_pos(tgt2)
        tgt = tgt + self.self_attn(q, q, tgt2,
                                   key_padding_mask=key_padding_mask)

        tgt2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn(with_pos(tgt2), context, context)

        tgt2 = self.norm3(tgt)
        grid = tgt2.transpose(1, 2).reshape(B, E, h, w)
        grid = self.conv2(F.gelu(self.conv1(grid)))
        return tgt + grid.reshape(B, E, L).transpose(1, 2)
