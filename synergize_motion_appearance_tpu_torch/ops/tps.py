"""Random thin-plate-spline warps for the equivariance loss.

Counterpart of ``synergize_motion_appearance_tpu/ops/tps.py`` (the
reference's ``Transform``, models/appmotioncomp_model.py:51-105): a random
affine plus a TPS radial term over a P x P grid of control points, with
L1 distances r and the term r^2 log(r + 1e-6).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .coords import make_coordinate_grid


class RandomTPSParams(NamedTuple):
    theta: torch.Tensor           # (B, 2, 3) affine
    control_points: torch.Tensor  # (1, P*P, 2)
    control_params: torch.Tensor  # (B, 1, P*P)


def sample_random_tps(generator, batch, sigma_affine, sigma_tps, points_tps,
                      device=None):
    """Draw the random transform from a ``torch.Generator``."""
    device = device or generator.device
    noise = sigma_affine * torch.randn(batch, 2, 3, generator=generator,
                                       device=device)
    theta = noise + torch.eye(2, 3, device=device)[None]
    cp = make_coordinate_grid(points_tps, points_tps,
                              device=device).reshape(1, -1, 2)
    cparam = sigma_tps * torch.randn(batch, 1, points_tps ** 2,
                                     generator=generator, device=device)
    return RandomTPSParams(theta, cp, cparam)


def _radial(params, coordinates):
    """(differences (B, N, P^2, 2), L1 distances (B, N, P^2))."""
    diff = coordinates[:, :, None, :] - params.control_points[:, None]
    return diff, diff.abs().sum(-1)


def tps_warp_coordinates(params: RandomTPSParams, coordinates):
    """(B, N, 2) points -> warped (B, N, 2)."""
    theta = params.theta
    transformed = (torch.einsum("bij,bnj->bni", theta[:, :, :2], coordinates)
                   + theta[:, None, :, 2])
    _, r = _radial(params, coordinates)
    result = (r ** 2 * torch.log(r + 1e-6)) * params.control_params
    return transformed + result.sum(dim=2)[..., None]


def tps_warp_frame_grid(params: RandomTPSParams, h: int, w: int):
    """(B, h, w, 2) grid that warps a frame with grid_sample."""
    grid = make_coordinate_grid(h, w, device=params.theta.device)
    batch = params.theta.shape[0]
    grid = grid.reshape(1, h * w, 2).expand(batch, h * w, 2)
    return tps_warp_coordinates(params, grid).reshape(batch, h, w, 2)


def tps_jacobian(params: RandomTPSParams, coordinates):
    """d warp / d point, (B, N, 2, 2); row i is the gradient of output i.
    Closed form of the JAX package's jacfwd: the radial term f(r) =
    r^2 log(r + 1e-6) adds sum_p c_p f'(r_p) dr_p/dxy_j to both outputs,
    with dr/dx = +1 where x - cx >= 0 and -1 below (JAX's derivative of
    |.|, which is +1 at 0)."""
    diff, r = _radial(params, coordinates)
    fprime = 2.0 * r * torch.log(r + 1e-6) + r ** 2 / (r + 1e-6)
    sign = torch.where(diff >= 0, 1.0, -1.0)
    g = torch.einsum("bnp,bnpj->bnj", fprime * params.control_params, sign)
    return params.theta[:, None, :, :2] + g[:, :, None, :]
