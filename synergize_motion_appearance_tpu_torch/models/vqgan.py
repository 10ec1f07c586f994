"""VQGAN encoder/generator blocks, the codebook and the discriminator, NCHW.

Counterpart of the JAX package's models/vqgan.py (reference
archs/vqgan_arch.py). The encoder and generator are ``nn.ModuleList``s with
the reference's per-index structure, because AppMotionCompFormer taps skip
features at fixed block indices. Their 3x3 convs are ``layers.Conv2d``,
which runs kernel K3 inside the training forward's decoder region.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import upsample_nearest, vq_quantize
from .layers import BatchNorm2d, Conv2d, GroupNorm32, swish


class VQGANResBlock(nn.Module):
    """GroupNorm32 + swish + conv, twice, with a 1x1 shortcut on a channel
    change (vqgan_arch.py:168-191)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_out = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x_in):
        x = self.conv1(swish(self.norm1(x_in)))
        x = self.conv2(swish(self.norm2(x)))
        if self.conv_out is not None:
            x_in = self.conv_out(x_in)
        return x + x_in


class AttnBlock(nn.Module):
    """Spatial self-attention with 1x1-conv q/k/v (vqgan_arch.py:194-253).
    Dense softmax in the JAX package too (no kernel): a matmul, a float32
    softmax and a matmul."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h_ = self.norm(x)
        q = self.q(h_).reshape(B, C, H * W)
        k = self.k(h_).reshape(B, C, H * W)
        v = self.v(h_).reshape(B, C, H * W)
        w_ = torch.bmm(q.transpose(1, 2), k) * (C ** -0.5)   # (B, HW, HW)
        w_ = torch.softmax(w_.float(), dim=2).to(v.dtype)
        h_ = torch.bmm(v, w_.transpose(1, 2)).reshape(B, C, H, W)
        return x + self.proj_out(h_)


class Downsample(nn.Module):
    """Pad (0, 1, 0, 1), then a 3x3 stride-2 conv (vqgan_arch.py:144-153)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (vqgan_arch.py:156-165)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest(x, 2))


def encoder_block_defs(nf: int, emb_dim: int, ch_mult: Sequence[int],
                       num_res_blocks: int, resolution: int,
                       attn_resolutions: Sequence[int]):
    """(kind, channels) list mirroring Encoder.__init__
    (vqgan_arch.py:256-294); kinds: conv/res/attn/down/norm."""
    defs: List[Tuple[str, int]] = []
    curr_res = resolution
    defs.append(("conv", nf))
    block_in_ch = nf
    for i in range(len(ch_mult)):
        block_out_ch = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            defs.append(("res", block_out_ch))
            block_in_ch = block_out_ch
            if curr_res in attn_resolutions:
                defs.append(("attn", block_in_ch))
        if i != len(ch_mult) - 1:
            defs.append(("down", block_in_ch))
            curr_res = curr_res // 2
    defs += [("res", block_in_ch), ("attn", block_in_ch),
             ("res", block_in_ch), ("norm", block_in_ch), ("conv", emb_dim)]
    return defs


def generator_block_defs(nf: int, emb_dim: int, ch_mult: Sequence[int],
                         num_res_blocks: int, resolution: int,
                         attn_resolutions: Sequence[int],
                         out_channels: int = 3):
    """(kind, channels) list mirroring Generator.__init__
    (vqgan_arch.py:303-343)."""
    defs: List[Tuple[str, int]] = []
    block_in_ch = nf * ch_mult[-1]
    curr_res = resolution // 2 ** (len(ch_mult) - 1)
    defs += [("conv", block_in_ch), ("res", block_in_ch),
             ("attn", block_in_ch), ("res", block_in_ch)]
    for i in reversed(range(len(ch_mult))):
        block_out_ch = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            defs.append(("res", block_out_ch))
            block_in_ch = block_out_ch
            if curr_res in attn_resolutions:
                defs.append(("attn", block_in_ch))
        if i != 0:
            defs.append(("up", block_in_ch))
            curr_res = curr_res * 2
    defs += [("norm", block_in_ch), ("conv", out_channels)]
    return defs


def make_blocks(defs, in_channels: int) -> nn.ModuleList:
    """Modules for a block def list; ``in_channels`` feeds block 0."""
    blocks = []
    ch = in_channels
    for kind, out in defs:
        if kind == "conv":
            blocks.append(Conv2d(ch, out, 3, padding=1))
            ch = out
        elif kind == "res":
            blocks.append(VQGANResBlock(ch, out))
            ch = out
        elif kind == "attn":
            blocks.append(AttnBlock(ch))
        elif kind == "down":
            blocks.append(Downsample(ch))
        elif kind == "up":
            blocks.append(Upsample(ch))
        elif kind == "norm":
            blocks.append(GroupNorm32(ch))
        else:
            raise ValueError(kind)
    return nn.ModuleList(blocks)


class Encoder(nn.Module):
    def __init__(self, nf: int = 64, emb_dim: int = 256,
                 ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, resolution: int = 256,
                 attn_resolutions: Sequence[int] = (32,),
                 in_channels: int = 3):
        super().__init__()
        self.blocks = make_blocks(
            encoder_block_defs(nf, emb_dim, ch_mult, num_res_blocks,
                               resolution, attn_resolutions), in_channels)

    def forward(self, x, taps: Sequence[int] = ()):
        """All blocks; returns (latent, {block index: feature})."""
        tap_out = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in taps:
                tap_out[i] = x
        return x, tap_out


class Generator(nn.Module):
    """The decoder's blocks. AppMotionCompFormer runs them one by one,
    fusing the warped source features after the tap blocks; ``forward``
    runs them all, as the autoencoders do."""

    def __init__(self, nf: int = 64, emb_dim: int = 256,
                 ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, resolution: int = 256,
                 attn_resolutions: Sequence[int] = (32,)):
        super().__init__()
        self.blocks = make_blocks(
            generator_block_defs(nf, emb_dim, ch_mult, num_res_blocks,
                                 resolution, attn_resolutions), emb_dim)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class VectorQuantizer(nn.Module):
    """The codebook (vqgan_arch.py:24-111): read in slices as attention
    context, and quantized against in the training forward."""

    def __init__(self, codebook_size: int, emb_dim: int, beta: float = 0.25):
        super().__init__()
        self.codebook_size = codebook_size
        self.beta = beta
        self.embedding = nn.Embedding(codebook_size, emb_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / codebook_size,
                         1.0 / codebook_size)

    def forward(self, z, start: int = 0, num: Optional[int] = None):
        """Quantize channel-last ``z`` (..., emb_dim) against
        codebook[start:start + num]: (z_q, commit loss, stats)."""
        return vq_quantize(z, self.embedding.weight, self.beta, start, num)

    def codebook_slice(self, start: int = 0, num: Optional[int] = None):
        """Codebook entries ``start`` to ``start + num`` (by default to the
        end), (num, emb_dim)."""
        if num is None:
            num = self.codebook_size - start
        return self.embedding.weight[start:start + num]


class VQGANDiscriminator(nn.Module):
    """PatchGAN discriminator (vqgan_arch.py:535-575) with train-mode
    BatchNorm. ``main`` is the reference's Sequential, so its state_dict
    names are the reference's."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        layers: List[nn.Module] = [nn.Conv2d(nc, ndf, 4, 2, 1),
                                   nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride, 1,
                                 bias=False),
                       BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x)


class VQAutoEncoder(nn.Module):
    """Encoder -> VectorQuantizer -> Generator (vqgan_arch.py:467-530), the
    codebook model of stage-1 training. Returns (reconstruction, the
    codebook loss, the quantizer's stats), as the JAX module does. Its
    convs are plain cuDNN convs: it never enters the decoder region."""

    def __init__(self, img_size: int = 256, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 codebook_size: int = 1024, emb_dim: int = 256,
                 beta: float = 0.25):
        super().__init__()
        self.encoder = Encoder(nf, emb_dim, ch_mult, res_blocks, img_size,
                               attn_resolutions)
        self.quantize = VectorQuantizer(codebook_size, emb_dim, beta)
        self.generator = Generator(nf, emb_dim, ch_mult, res_blocks,
                                   img_size, attn_resolutions)

    def forward(self, x):
        x, _ = self.encoder(x)
        quant, codebook_loss, quant_stats = self.quantize(
            x.permute(0, 2, 3, 1))
        x = self.generator(quant.permute(0, 3, 1, 2))
        return x, codebook_loss, quant_stats


class AutoEncoder(nn.Module):
    """The codebook-free autoencoder (vqgan_arch.py:578-627)."""

    def __init__(self, img_size: int = 256, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 emb_dim: int = 256):
        super().__init__()
        self.encoder = Encoder(nf, emb_dim, ch_mult, res_blocks, img_size,
                               attn_resolutions)
        self.generator = Generator(nf, emb_dim, ch_mult, res_blocks,
                                   img_size, attn_resolutions)

    def forward(self, x):
        return self.generator(self.encoder(x)[0])
