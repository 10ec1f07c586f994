"""Dense motion network and the motion-estimator wrapper, NCHW.

Counterpart of the JAX package's models/dense_motion.py (reference
archs/dense_motion_arch.py:12-161, archs/motion_estimator_arch.py:14-52):
  heatmaps gauss(kp_d) - gauss(kp_s) of variance ``kp_variance``, with a
  zero background map;
  sparse flows from the keypoints, affine by J_s J_d^-1 when the
  keypoints carry Jacobians, else shifts;
  the source warped K+1 ways (grid_sample, align_corners=False, zeros);
  Hourglass -> softmax mask -> deformation = sum(mask * sparse flow);
  with ``estimate_occlusion_map``, occlusion = sigmoid(7x7 conv) of the
  last decoder feature, or with ``multi_mask`` a coarse-to-fine list of
  ``occlusion_num`` such maps (dense_motion_arch.py:34-54, 148-156).
Flows stay float32 whatever the compute dtype, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn as nn

from ..ops import grid_sample_grouped, kp2gaussian, make_coordinate_grid
from .keypoint_detector import AntiAliasInterpolation2d, KPDetector
from .motion_blocks import Hourglass, UpBlock2d


def inv2x2(m):
    """Inverse of (..., 2, 2) matrices in closed form (no solver launch,
    no host sync)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


class DenseMotionNetwork(nn.Module):
    def __init__(self, block_expansion: int = 64, num_blocks: int = 5,
                 max_features: int = 1024, num_kp: int = 15,
                 num_channels: int = 3, estimate_occlusion_map: bool = True,
                 scale_factor: float = 0.25, kp_variance: float = 0.01,
                 multi_mask: bool = False, occlusion_num: int = 5):
        super().__init__()
        self.num_kp = num_kp
        self.scale_factor = scale_factor
        self.kp_variance = kp_variance
        in_features = (num_kp + 1) * (num_channels + 1)
        self.hourglass = Hourglass(block_expansion, in_features, num_blocks,
                                   max_features)
        out_filters = self.hourglass.out_filters
        self.mask = nn.Conv2d(out_filters, num_kp + 1, 7, padding=3)
        self.occlusion = None
        self.up_nums = 0
        if estimate_occlusion_map and multi_mask:
            # the first occlusion_num - up_nums heads read the tail
            # stages of the hourglass decoder; an UpBlock2d chain carries
            # its last feature back up to the input's resolution, with one
            # head after each step
            self.up_nums = int(math.log(1.0 / scale_factor, 2))
            n_direct = occlusion_num - self.up_nums
            if not 0 <= n_direct <= num_blocks:
                raise ValueError(
                    f"multi_mask: occlusion_num {occlusion_num} needs "
                    f"{n_direct} hourglass decoder stages, of {num_blocks}")
            stage_ch = self.hourglass.decoder.stage_channels[-n_direct:] \
                if n_direct else []
            up_ch = [out_filters // 2 ** i for i in range(self.up_nums + 1)]
            self.up = nn.ModuleList(
                [UpBlock2d(up_ch[i], up_ch[i + 1])
                 for i in range(self.up_nums)])
            self.occlusion = nn.ModuleList(
                [nn.Conv2d(c, 1, 7, padding=3)
                 for c in stage_ch + up_ch[1:]])
        elif estimate_occlusion_map:
            self.occlusion = nn.Conv2d(out_filters, 1, 7, padding=3)
        if scale_factor != 1:
            self.down = AntiAliasInterpolation2d(num_channels, scale_factor)

    def _heatmaps(self, spatial, kp_driving, kp_source):
        g_d = kp2gaussian(kp_driving["value"], spatial, self.kp_variance)
        g_s = kp2gaussian(kp_source["value"], spatial, self.kp_variance)
        heatmap = g_d - g_s                                  # (B, K, h, w)
        zeros = torch.zeros_like(heatmap[:, :1])
        return torch.cat([zeros, heatmap], dim=1)            # (B, K+1, h, w)

    def _sparse_motions(self, spatial, kp_driving, kp_source):
        h, w = spatial
        value_d = kp_driving["value"]
        B, K = value_d.shape[:2]
        identity = make_coordinate_grid(h, w, device=value_d.device)
        identity = identity[None, None]                      # (1,1,h,w,2)
        coord = identity - value_d.float().reshape(B, K, 1, 1, 2)
        if kp_driving.get("jacobian") is not None:
            jac = kp_source["jacobian"].float() @ inv2x2(
                kp_driving["jacobian"].float())              # (B, K, 2, 2)
            coord = torch.einsum("bkij,bkhwj->bkhwi", jac, coord)
        driving_to_source = coord + kp_source["value"].float().reshape(
            B, K, 1, 1, 2)
        identity = identity.expand(B, 1, h, w, 2)
        return torch.cat([identity, driving_to_source], dim=1)

    def _occlusion(self, prediction):
        """The sigmoid occlusion map of the last decoder feature, or the
        multi-mask list, coarse to fine."""
        if not isinstance(self.occlusion, nn.ModuleList):
            return torch.sigmoid(self.occlusion(prediction[-1]))
        n_direct = len(self.occlusion) - self.up_nums
        feats = list(prediction[len(prediction) - n_direct:])
        p = prediction[-1]
        for up in self.up:
            p = up(p)
            feats.append(p)
        return [torch.sigmoid(head(f))
                for head, f in zip(self.occlusion, feats)]

    def forward(self, source_image, kp_driving, kp_source,
                pre_downsampled: bool = False) -> Dict[str, Any]:
        """source_image (1 or B, C, H, W); keypoints of batch B. A batch-1
        source is shared by every driving frame without being copied."""
        x = source_image
        if self.scale_factor != 1 and not pre_downsampled:
            x = self.down(x)
        B = kp_driving["value"].shape[0]
        _, C, h, w = x.shape
        Kp1 = self.num_kp + 1

        heatmap = self._heatmaps((h, w), kp_driving, kp_source)
        sparse_motion = self._sparse_motions((h, w), kp_driving, kp_source)
        deformed = grid_sample_grouped(x, sparse_motion,
                                       align_corners=False,
                                       padding_mode="zeros")  # (B,(K+1)C,h,w)
        # hourglass input interleaves per kp: [heat_k, r, g, b]
        inp = torch.cat([heatmap.reshape(B, Kp1, 1, h, w).to(deformed.dtype),
                         deformed.reshape(B, Kp1, C, h, w)], dim=2)
        inp = inp.reshape(B, Kp1 * (C + 1), h, w)
        prediction = self.hourglass(inp.to(self.mask.weight.dtype), mode=1)

        mask = torch.softmax(self.mask(prediction[-1]), dim=1)  # (B,K+1,h,w)
        deformation = torch.einsum("bkhw,bkhwc->bhwc", mask.float(),
                                   sparse_motion)
        out = {
            "sparse_motion": sparse_motion,
            "mask": mask,
            "deformation": deformation,
            "kp_heatmap": heatmap,
            "driving_kp_heatmap": kp2gaussian(
                kp_driving["value"], (h, w), self.kp_variance),
            "source": x,
        }
        if self.occlusion is not None:  # (B, 1, h, w), or a list of them
            out["occlusion_map"] = self._occlusion(prediction)
        return out


class MotionEstimator(nn.Module):
    """KPDetector + DenseMotionNetwork (reference
    Motion_Estimator_keypoint_aware)."""

    def __init__(self, common_params: Dict[str, Any],
                 dense_motion_params: Dict[str, Any],
                 kp_detector_params: Dict[str, Any]):
        super().__init__()
        self.kp_detector = KPDetector(**common_params, **kp_detector_params)
        self.dense_motion_network = DenseMotionNetwork(
            **common_params, **dense_motion_params)

    def forward(self, driving_image, source_image):
        """Keypoints of both frames and the dense motion from the source to
        the driving frame (the JAX module's ``__call__``, which the
        training step runs). In train mode the BatchNorm statistics update
        in call order: driving keypoints, source keypoints, dense motion."""
        kp_driving = self.kp_detector(driving_image)
        kp_source = self.kp_detector(source_image)
        return self.estimate_motion_w_kp(kp_source, kp_driving, source_image)

    def estimate_kp(self, image, pre_downsampled: bool = False):
        return self.kp_detector(image, pre_downsampled)

    def estimate_motion_w_kp(self, kp_source, kp_driving, source_image,
                             pre_downsampled: bool = False):
        dense_motion = self.dense_motion_network(
            source_image, kp_driving, kp_source, pre_downsampled)
        dense_motion.update({"kp_driving": kp_driving,
                             "kp_source": kp_source})
        return dense_motion
