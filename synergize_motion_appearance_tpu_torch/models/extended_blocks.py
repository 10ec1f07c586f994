"""The rest of the motion-block library, NCHW (NCDHW for the 3-D blocks).

Counterpart of every public name of the JAX package's
models/extended_blocks.py (the reference's utils/motion_estimator_util.py:
the weight-normed blocks :189-416, ResBottleneck :272-301, the
pixel-shuffle blocks :304-341 and :419-437, Decoder_w_emb :494-521,
Hourglass_2branch :565-581, Hourglass_w_emb :584-598, SPADE :648-710,
the 3-D blocks and KPHourglass :233-251 and :970-1001, the keypoint TPS
:723-809, the head-pose math :92-161, the sinusoidal embeddings
:811-967, make_coordinate_grid_3d :74-90). No path of the flagship config
runs them.

Names. No converter in tools/ maps these blocks and the upstream
reference is not in the repository, so each submodule takes the JAX
module's name (``up_0``, ``down0``, ``norm_0``, ``mlp_shared``, ...), as
``models.vqgan_extras.MSGenerator`` does; the hourglass encoders and
decoders they share with the main path are ``motion_blocks``' (reference
names), and ``weights.block_state_dict`` maps them all from flax params.
A weight-normed conv keeps torch's ``weight_norm`` names, ``weight_g``
(out, 1, 1, 1) and ``weight_v``, with the JAX arithmetic
(v / (||v|| + 1e-12) * g). ``UpBlock3d``'s conv is ``conv`` (flax names
it ``Conv_0``).

Layouts. Channel order of ``pixel_shuffle`` / ``pixel_unshuffle`` is the
JAX package's, (row phase, column phase, channel), where torch's
``F.pixel_shuffle`` reads (channel, row phase, column phase). BatchNorm
is ``layers.BatchNorm2d`` (the JAX update rule; global statistics in a
process group), put in train or eval mode with the module, where the JAX
blocks take a ``train`` argument; the 3-D blocks normalise their
(B, C, D, H, W) volume as one (B, C, D*H, W) map, which has the same
statistics. Keypoint, head-pose and TPS functions work on (B, K, 2 or 3)
tensors as the JAX ones do; the embeddings return float32 tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import avg_pool_2x, resize_nearest, upsample_nearest
from .layers import BatchNorm2d
from .motion_blocks import (DownBlock2d, HourglassDecoder, HourglassEncoder,
                            UpBlock2d)


# ---------------------------------------------------------------------------
# weight-normalized variants (w = g * v / ||v||)
# ---------------------------------------------------------------------------

class WNConv2d(nn.Module):
    """Conv with the weight-norm reparameterization: per-output-channel
    magnitude ``weight_g``, direction ``weight_v``; g starts at ||v||, so
    the first output is the plain conv's."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 padding: int = 1, groups: int = 1):
        super().__init__()
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.padding, self.groups = padding, groups
        v = torch.empty(features, in_channels // groups, kh, kw)
        nn.init.kaiming_uniform_(v, a=math.sqrt(5))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            v.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt())
        self.bias = nn.Parameter(torch.zeros(features))

    def weight(self):
        v = self.weight_v
        norm = v.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt()
        return v / (norm + 1e-12) * self.weight_g

    def forward(self, x):
        return F.conv2d(x, self.weight(), self.bias, padding=self.padding,
                        groups=self.groups)


class WNResBlock2d(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = WNConv2d(features, features)
        self.conv2 = WNConv2d(features, features)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class WNUpBlock2d(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = WNConv2d(in_features, features)
        self.norm = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(upsample_nearest(x, 2))))


class WNDownBlock2d(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = WNConv2d(in_features, features)

    def forward(self, x):
        return avg_pool_2x(F.relu(self.conv(x)))


class WNSameBlock2d(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = WNConv2d(in_features, features)

    def forward(self, x):
        return F.relu(self.conv(x))


class ResBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck with BatchNorm, and a
    strided 1x1 skip when ``stride`` is not 1 (:272-301)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        f4 = features // 4
        self.stride = stride
        self.conv1 = nn.Conv2d(in_features, f4, 1)
        self.norm1 = BatchNorm2d(f4)
        self.conv2 = nn.Conv2d(f4, f4, 3, stride=stride, padding=1)
        self.norm2 = BatchNorm2d(f4)
        self.conv3 = nn.Conv2d(f4, features, 1)
        self.norm3 = BatchNorm2d(features)
        if stride != 1:
            self.skip = nn.Conv2d(in_features, features, 1, stride=stride)
            self.norm4 = BatchNorm2d(features)

    def forward(self, x):
        out = F.relu(self.norm1(self.conv1(x)))
        out = F.relu(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        if self.stride != 1:
            x = self.norm4(self.skip(x))
        return F.relu(out + x)


# ---------------------------------------------------------------------------
# pixel-shuffle resampling (:419-437), in the JAX package's channel order
# ---------------------------------------------------------------------------

def pixel_shuffle(x, factor: int):
    """(B, f*f*c, H, W) -> (B, c, H*f, W*f); input channel (i*f + j)*c + k
    lands at row phase i, column phase j of output channel k."""
    B, C, H, W = x.shape
    c = C // (factor * factor)
    x = x.reshape(B, factor, factor, c, H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, c, H * factor, W * factor)


def pixel_unshuffle(x, factor: int):
    """The inverse of ``pixel_shuffle``: (B, C, H, W) -> (B, f*f*C, H/f,
    W/f)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // factor, factor, W // factor, factor)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, factor * factor * C, H // factor, W // factor)


class PixelShuffle(nn.Module):
    """``pixel_shuffle`` as a module (for ``nn.Sequential`` towers)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return pixel_shuffle(x, self.factor)


class PixelShuffleUpsample(nn.Module):
    """conv (dim -> dim * s^2, no bias) + pixel_shuffle (:429-437)."""

    def __init__(self, dim: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(dim, dim * scale ** 2, 3, padding=1, bias=False)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.scale)


class PixelUnshuffleDownsample(nn.Module):
    """conv (dim -> dim / s^2, no bias) + pixel_unshuffle (:419-427)."""

    def __init__(self, dim: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(dim, dim // scale ** 2, 3, padding=1,
                              bias=False)

    def forward(self, x):
        return pixel_unshuffle(self.conv(x), self.scale)


class SubPixelUpBlock2d(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.upsample = PixelShuffleUpsample(in_features, 2)
        self.conv = nn.Conv2d(in_features, features, 3, padding=1)
        self.norm = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(self.upsample(x))))


# ---------------------------------------------------------------------------
# Hourglass variants (:494-598)
# ---------------------------------------------------------------------------

class DecoderWEmb(nn.Module):
    """The hourglass decoder returning (final, per-stage features): the
    encoder's deepest output and each skip it concatenates (:494-521)."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        self.num_blocks = num_blocks
        for j, i in enumerate(reversed(range(num_blocks))):
            cin = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * 2 ** (i + 1))
            cout = min(max_features, block_expansion * 2 ** i)
            self.add_module(f"up_{j}", UpBlock2d(cin, cout))

    def forward(self, skips: List[torch.Tensor]):
        skips = list(skips)
        out = skips.pop()
        feats = [out]
        for j in range(self.num_blocks):
            out = getattr(self, f"up_{j}")(out)
            skip = skips.pop()
            feats.append(skip)
            out = torch.cat([out, skip], dim=1)
        return out, feats


class Hourglass2Branch(nn.Module):
    """A shared encoder and two decoders, keypoints and mask
    (:565-581): (kp, mask), each the last stage's output."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        args = (block_expansion, in_features, num_blocks, max_features)
        self.encoder = HourglassEncoder(*args)
        self.decoder_kp = HourglassDecoder(*args)
        self.decoder_mask = HourglassDecoder(*args)

    def forward(self, x):
        skips = self.encoder(x)
        return self.decoder_kp(skips)[-1], self.decoder_mask(skips)[-1]


class HourglassWEmb(nn.Module):
    """The hourglass returning (per-stage features, final) (:584-598)."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        args = (block_expansion, in_features, num_blocks, max_features)
        self.encoder = HourglassEncoder(*args)
        self.decoder = DecoderWEmb(*args)

    def forward(self, x):
        out, feats = self.decoder(self.encoder(x))
        return feats, out


# ---------------------------------------------------------------------------
# SPADE (:648-710)
# ---------------------------------------------------------------------------

class SPADE(nn.Module):
    """Parameter-free instance norm (biased variance, eps 1e-5),
    modulated by gamma and beta convs of the nearest-resized segmap."""

    def __init__(self, norm_nc: int, label_nc: int):
        super().__init__()
        self.mlp_shared = nn.Conv2d(label_nc, 128, 3, padding=1)
        self.mlp_gamma = nn.Conv2d(128, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(128, norm_nc, 3, padding=1)

    def forward(self, x, segmap):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True,
                                   unbiased=False)
        normalized = (x - mean) * torch.rsqrt(var + 1e-5)
        segmap = resize_nearest(segmap, tuple(x.shape[2:]))
        actv = F.relu(self.mlp_shared(segmap))
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, label_nc: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.norm_0 = SPADE(fin, label_nc)
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.norm_1 = SPADE(fmiddle, label_nc)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, label_nc)
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)

    def forward(self, x, seg):
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        xs = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
              else x)
        return xs + dx


# ---------------------------------------------------------------------------
# 3-D blocks + KPHourglass (:233-251, :970-1001)
# ---------------------------------------------------------------------------

def make_coordinate_grid_3d(d: int, h: int, w: int, dtype=torch.float32,
                            device=None):
    """(d, h, w, 3) grid of (x, y, z) in [-1, 1]^3 (:74-90)."""
    def axis(n):
        return 2.0 * (torch.arange(n, dtype=dtype, device=device) / (n - 1)) \
            - 1.0

    z, y, x = torch.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
    return torch.stack([x, y, z], dim=-1)


class UpBlock3d(nn.Module):
    """Nearest (1, 2, 2) upsample, 3x3x3 conv and BatchNorm, ReLU
    (:233-251); (B, C, D, H, W)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 3, padding=1)
        self.norm = BatchNorm2d(features)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        x = self.conv(x)
        B, C, D, H, W = x.shape
        x = self.norm(x.reshape(B, C, D * H, W)).reshape(B, C, D, H, W)
        return F.relu(x)


class KPHourglass(nn.Module):
    """2-D down blocks, a 1x1 conv, the channels split into a
    (reshape_depth, C / reshape_depth) volume, then 3-D up blocks
    (:970-1001). (B, in_features, H, W) -> (B, C', D, H', W')."""

    def __init__(self, block_expansion: int, in_features: int,
                 reshape_features: int, reshape_depth: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        self.num_blocks, self.reshape_depth = num_blocks, reshape_depth
        cin = in_features
        for i in range(num_blocks):
            feats = min(max_features, block_expansion * 2 ** (i + 1))
            self.add_module(f"down{i}", DownBlock2d(cin, feats))
            cin = feats
        self.conv = nn.Conv2d(cin, reshape_features, 1)
        cin = reshape_features // reshape_depth
        for i in range(num_blocks):
            feats = min(max_features,
                        block_expansion * 2 ** (num_blocks - i - 1))
            self.add_module(f"up{i}", UpBlock3d(cin, feats))
            cin = feats

    def forward(self, x):
        out = x
        for i in range(self.num_blocks):
            out = getattr(self, f"down{i}")(out)
        out = self.conv(out)
        B, C, H, W = out.shape
        D = self.reshape_depth
        out = out.reshape(B, D, C // D, H, W).permute(0, 2, 1, 3, 4)
        for i in range(self.num_blocks):
            out = getattr(self, f"up{i}")(out)
        return out


# ---------------------------------------------------------------------------
# head-pose math (:92-161)
# ---------------------------------------------------------------------------

def headpose_pred_to_degree(pred):
    """(B, 66) head-pose bin logits -> (B,) degrees (:92-99)."""
    idx = torch.arange(66, dtype=pred.dtype, device=pred.device)
    return (torch.softmax(pred, dim=-1) * idx).sum(dim=1) * 3 - 99


def get_rotation_matrix(yaw, pitch, roll):
    """(B,) degrees -> (B, 3, 3) rotations, pitch @ yaw @ roll
    (:101-129)."""
    yaw, pitch, roll = (a / 180 * math.pi for a in (yaw, pitch, roll))
    o, z = torch.ones_like(pitch), torch.zeros_like(pitch)

    def mat(*entries):
        return torch.stack(entries, dim=1).reshape(-1, 3, 3)

    pitch_mat = mat(o, z, z, z, torch.cos(pitch), -torch.sin(pitch),
                    z, torch.sin(pitch), torch.cos(pitch))
    yaw_mat = mat(torch.cos(yaw), z, torch.sin(yaw), z, o, z,
                  -torch.sin(yaw), z, torch.cos(yaw))
    roll_mat = mat(torch.cos(roll), -torch.sin(roll), z,
                   torch.sin(roll), torch.cos(roll), z, z, z, o)
    return torch.einsum("bij,bjk,bkm->bim", pitch_mat, yaw_mat, roll_mat)


def keypoint_transformation(kp_canonical: Dict[str, torch.Tensor],
                            he: Dict[str, torch.Tensor]):
    """Canonical 3-D keypoints and a head-pose dict (yaw, pitch, roll
    logits, translation t, expression exp, optional exp_jacobian) ->
    posed keypoints {'value', 'jacobian'} (:131-161)."""
    kp = kp_canonical["value"]                                # (B, K, 3)
    rot = get_rotation_matrix(headpose_pred_to_degree(he["yaw"]),
                              headpose_pred_to_degree(he["pitch"]),
                              headpose_pred_to_degree(he["roll"]))
    kp_t = torch.einsum("bmp,bkp->bkm", rot, kp) + he["t"][:, None, :]
    out = {"value": kp_t + he["exp"].reshape(kp.shape[0], -1, 3),
           "jacobian": None}
    if kp_canonical.get("jacobian") is not None:
        jt = torch.einsum("bmp,bkps->bkms", rot, kp_canonical["jacobian"])
        if "exp_jacobian" in he:
            jt = jt + he["exp_jacobian"].reshape(kp.shape[0], -1, 3, 3)
        out["jacobian"] = jt
    return out


# ---------------------------------------------------------------------------
# keypoint-driven thin-plate splines (:723-809)
# ---------------------------------------------------------------------------

def tps_kp_params(kp_1, kp_2, reg: float = 0.01):
    """Fit per-group TPS mapping kp_1 -> kp_2, both (B, G, N, 2), with
    the r^2 log(r^2 + 1e-9) basis and ``reg`` on the diagonal (:744-765).
    Returns (theta (B, G, 2, 3), control points kp_1, control params
    (B, G, N, 2)); the system is solved in float32."""
    B, G, N, _ = kp_1.shape
    d = kp_1[:, :, :, None, :] - kp_1[:, :, None, :, :]
    K = (d ** 2).sum(dim=-1)
    K = K * torch.log(K + 1e-9)
    one = kp_1.new_ones(B, G, N, 1)
    kp1p = torch.cat([kp_1, one], dim=3)                      # (B, G, N, 3)
    P = torch.cat([kp1p, kp_1.new_zeros(B, G, 3, 3)], dim=2)  # (B, G, N+3, 3)
    L = torch.cat([K, kp1p.transpose(2, 3)], dim=2)
    L = torch.cat([L, P], dim=3)                          # (B, G, N+3, N+3)
    Y = torch.cat([kp_2, kp_1.new_zeros(B, G, 3, 2)], dim=2)
    L = L + torch.eye(L.shape[2], dtype=L.dtype, device=L.device) * reg
    param = torch.linalg.solve(L.float(), Y.float())
    theta = param[:, :, N:, :].transpose(2, 3)               # (B, G, 2, 3)
    return theta, kp_1, param[:, :, :N, :]


def tps_kp_warp(theta, control_points, control_params, coordinates):
    """(B, M, 2) coordinates through the fitted keypoint TPS (:783-792):
    (B, G, M, 2)."""
    affine = torch.einsum("bgij,bmj->bgmi", theta[..., :2], coordinates)
    affine = affine + theta[..., 2][:, :, None, :]
    d = coordinates[:, None, :, None, :] - control_points[:, :, None, :, :]
    r2 = (d ** 2).sum(dim=-1)                                 # (B, G, M, N)
    radial = r2 * torch.log(r2 + 1e-9)
    return affine + torch.einsum("bgmn,bgni->bgmi", radial, control_params)


# ---------------------------------------------------------------------------
# sinusoidal positional embedding (:811-967)
# ---------------------------------------------------------------------------

def sinusoidal_embedding(num_embeddings: int, embedding_dim: int,
                         padding_idx: Optional[int] = None,
                         div_half_dim: bool = False) -> torch.Tensor:
    """(num_embeddings, 2 * (embedding_dim // 2)) table of sines then
    cosines, computed in float64 and returned in float32; the padding
    row is 0."""
    half = embedding_dim // 2
    step = (np.log(1e4) / half if div_half_dim
            else np.log(10000) / (half - 1))
    emb = np.exp(np.arange(half, dtype=np.float64) * -step)
    emb = np.arange(num_embeddings, dtype=np.float64)[:, None] * emb[None]
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if padding_idx is not None:
        emb[padding_idx] = 0
    return torch.from_numpy(emb.astype(np.float32))


def sinusoidal_grid_2d(height: int, width: int, embedding_dim: int,
                       padding_idx: int = 0) -> torch.Tensor:
    """(H, W, 2 * embedding_dim): each position's x embedding then its y
    embedding, from rows 1.. of the table (:910-956)."""
    table = sinusoidal_embedding(max(height, width) + padding_idx + 2,
                                 embedding_dim, padding_idx)
    x_emb = table[1:width + 1]
    y_emb = table[1:height + 1]
    return torch.cat([x_emb[None, :, :].expand(height, width, -1),
                      y_emb[:, None, :].expand(height, width, -1)], dim=-1)
