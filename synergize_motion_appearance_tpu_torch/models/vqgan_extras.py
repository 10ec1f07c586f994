"""VQGAN variants completing the JAX package's inventory, NCHW.

Counterpart of the JAX package's models/vqgan_extras.py (reference
archs/vqgan_arch.py): ``GumbelQuantizer`` (:114-141), ``MSGenerator``
(:352-464), ``AutoEncoderMSDecoder`` (:629-689, registered as
``AutoEncoder_MSDecoder``) and ``FuseFeatBlock`` (Fuse_feat_block,
appmotioncodebook_arch.py:54-62).

The repository has no reference names for ``MSGenerator``: no converter
maps it. So its modules take the JAX module names as attribute names
(``b0_conv_in``, ``b0_res_a``, ``b0_attn_a``, ``b1_res0``, ``b2_up0``,
``fuse_res0``, ``norm_out``, ``conv_out``, ...), and its state_dict keys
are those names. ``GumbelQuantizer`` keeps the reference's ``proj`` and
``embed.weight``, ``FuseFeatBlock`` its ``encode_enc``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, GroupNorm32
from .vqgan import AttnBlock, Encoder, Upsample, VQGANResBlock


def _draw_gumbel(shape, generator, device, dtype):
    """Standard Gumbel noise, -log(-log(u)) of u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = u.clamp_min(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer (:114-141). In training the noise comes
    from ``generator``; otherwise the forward is deterministic and hard.
    Returns (z_q, the KL term, {"min_encoding_indices": (B, H, W)})."""

    def __init__(self, codebook_size: int, emb_dim: int, num_hiddens: int,
                 straight_through: bool = False, kl_weight: float = 5e-4,
                 temp_init: float = 1.0):
        super().__init__()
        self.codebook_size = codebook_size
        self.straight_through = straight_through
        self.kl_weight = kl_weight
        self.temp_init = temp_init
        self.proj = nn.Conv2d(num_hiddens, codebook_size, 1)
        self.embed = nn.Embedding(codebook_size, emb_dim)

    def forward(self, z, train: bool = False,
                generator: Optional[torch.Generator] = None):
        hard = self.straight_through if train else True
        logits = self.proj(z)                                # (B, K, H, W)
        if train:
            g = _draw_gumbel(logits.shape, generator, logits.device,
                             logits.dtype)
            y = torch.softmax((logits + g) / self.temp_init, dim=1)
        else:
            y = torch.softmax(logits / self.temp_init, dim=1)
        if hard:
            y_hard = F.one_hot(y.argmax(dim=1), self.codebook_size)
            y = y + (y_hard.permute(0, 3, 1, 2).to(y.dtype) - y).detach()
        z_q = torch.einsum("bkhw,kd->bdhw", y, self.embed.weight)
        qy = torch.softmax(logits, dim=1)
        diff = self.kl_weight * (
            qy * torch.log(qy * self.codebook_size + 1e-10)).sum(dim=1).mean()
        return z_q, diff, {"min_encoding_indices": y.argmax(dim=1)}


class MSGenerator(nn.Module):
    """Multi-branch decoder (:352-464): branch i starts from the encoder
    tap at scale i (branch 0 from the latent), runs its residual (and
    attention) blocks at that scale and upsamples to full resolution; the
    branches are concatenated and fused. The inputs' channels are those
    of the latent (emb_dim) and of the encoder's levels at those scales
    (nf * ch_mult[2], [1], [0])."""

    def __init__(self, nf: int = 64, emb_dim: int = 256,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), res_blocks: int = 2,
                 img_size: int = 256, attn_resolutions: Sequence[int] = (32,),
                 out_channels: int = 3):
        super().__init__()
        num_res = len(ch_mult)
        if num_res != 4:
            raise ValueError("MSGenerator needs a ch_mult of length 4")
        in_channels = (emb_dim, nf * ch_mult[2], nf * ch_mult[1],
                       nf * ch_mult[0])
        self.branches = []
        cat = 0
        for i in range(num_res):
            curr_res = img_size // 2 ** (num_res - i - 1)
            ch = nf * ch_mult[-1 - i]
            names = []

            def add(name, module):
                setattr(self, f"b{i}_{name}", module)
                names.append(f"b{i}_{name}")

            h = in_channels[i]
            if i != num_res - 1:
                add("conv_in", Conv2d(h, ch, 3, padding=1))
                h = ch
            if i == 0:
                add("res_a", VQGANResBlock(h, ch))
                add("attn_a", AttnBlock(ch))
                add("res_b", VQGANResBlock(ch, ch))
                h = ch
            for j in range(num_res - 1 - i):
                add(f"res{j}", VQGANResBlock(h, ch))
                h = ch
                if curr_res in attn_resolutions:
                    add(f"attn{j}", AttnBlock(ch))
            if i != num_res - 1:
                for j in range(num_res - 1 - i):
                    add(f"up{j}", Upsample(ch))
            self.branches.append(names)
            cat += h
        out_ch = nf * ch_mult[0]
        self.fuse = []
        for j in range(res_blocks):
            setattr(self, f"fuse_res{j}", VQGANResBlock(cat, out_ch))
            self.fuse.append(f"fuse_res{j}")
            cat = out_ch
        self.norm_out = GroupNorm32(out_ch)
        self.conv_out = Conv2d(out_ch, out_channels, 3, padding=1)

    def forward(self, x0, x1, x2, x3):
        """x0: the lowest-resolution latent; x1..x3: the encoder taps at
        2x, 4x and 8x its resolution."""
        outs = []
        for names, h in zip(self.branches, (x0, x1, x2, x3)):
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        h = torch.cat(outs, dim=1)
        for name in self.fuse:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))


class AutoEncoderMSDecoder(nn.Module):
    """Encoder + MSGenerator fed the encoder's taps at 2x, 4x and 8x the
    latent's resolution (:629-689), the tap blocks those of
    ``appmotion_former.encoder_tap_indices``."""

    def __init__(self, img_size: int = 256, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 emb_dim: int = 256):
        super().__init__()
        from .appmotion_former import encoder_tap_indices

        n = len(ch_mult)
        self.scales = [img_size // 2 ** (n - 1 - i) for i in range(n)]
        taps = encoder_tap_indices(nf, emb_dim, ch_mult, res_blocks,
                                   img_size, attn_resolutions)
        self.tap_idx = {taps[r]: r for r in self.scales[1:]}
        self.encoder = Encoder(nf, emb_dim, ch_mult, res_blocks, img_size,
                               attn_resolutions)
        self.generator = MSGenerator(nf, emb_dim, ch_mult, res_blocks,
                                     img_size, attn_resolutions)

    def forward(self, x):
        latent, feats = self.encoder(x, taps=tuple(self.tap_idx))
        by_res = {self.tap_idx[i]: f for i, f in feats.items()}
        return self.generator(latent, *(by_res[r] for r in self.scales[1:]))


class FuseFeatBlock(nn.Module):
    """Residual concat-fusion (appmotioncodebook_arch.py:54-62):
    dec + ResBlock(cat(enc, dec)). ``in_ch`` is the concatenation's
    channels, by default twice ``out_ch``."""

    def __init__(self, out_ch: int, in_ch: Optional[int] = None):
        super().__init__()
        self.encode_enc = VQGANResBlock(in_ch or 2 * out_ch, out_ch)

    def forward(self, enc_feat, dec_feat):
        return dec_feat + self.encode_enc(torch.cat([enc_feat, dec_feat],
                                                    dim=1))
