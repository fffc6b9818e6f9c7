"""Reprojection factors: residuals + analytic Jacobians, batched.

Port of the pinhole path of ``orb_slam3_detailed_comments_kor_tpu/optim/
factors.py``. Poses are world-to-camera (R_cw, t_cw) with the
left-multiplicative update T_cw <- exp(xi)·T_cw, xi = (rho, phi); the
residual is observed - predicted; stereo rows carry u_right and residual
row 2 is u_r - (u - bf/z), masked for mono rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

# chi2 gates at 95% for 2/3 DoF (reference Optimizer.cc:905-908)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Observations(NamedTuple):
    """Flat observation table (the device-side edge list)."""

    kf: torch.Tensor          # [O] int64 keyframe index
    lm: torch.Tensor          # [O] int64 landmark index
    uv: torch.Tensor          # [O,2] float32 observed pixel
    u_right: torch.Tensor     # [O] float32 observed right-u; <0 -> mono
    inv_sigma2: torch.Tensor  # [O] float32 information scale (1/sigma^2)
    valid: torch.Tensor       # [O] bool

    @property
    def n(self) -> int:
        return self.kf.shape[0]


def _project(cam_params, pc, bf):
    """Pinhole + stereo row: pc [O,3] -> (pred [O,3] = (u, v, u_r), 1/z)."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    x, y = pc[..., 0], pc[..., 1]
    zi = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    return torch.stack([u, v, u - bf * zi], dim=-1), zi


def project_with_jac(cam_params, pc, bf, model: str = "pinhole"):
    """pc [O,3] -> (pred [O,3] = (u, v, u_r), J [O,3,3] = d pred / d pc)."""
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    fx, fy = cam_params[0], cam_params[1]
    x, y = pc[..., 0], pc[..., 1]
    pred, zi = _project(cam_params, pc, bf)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row_v = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    row_r = torch.stack([fx * zi, zero, -fx * x * zi2 + bf * zi2], dim=-1)
    return pred, torch.stack([row_u, row_v, row_r], dim=-2)


def _camera_points(R_cw, t_cw, X, obs: Observations):
    Rk = R_cw[obs.kf]
    return Rk, (Rk @ X[obs.lm][..., None])[..., 0] + t_cw[obs.kf]


def reproj_residuals(R_cw, t_cw, X, obs: Observations, cam_params, bf,
                     model: str = "pinhole"):
    """Residuals + per-row validity.

    R_cw [K,3,3], t_cw [K,3], X [L,3].
    Returns (r [O,3], row_mask [O,3] float, depth_ok [O] bool).
    """
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    _, pc = _camera_points(R_cw, t_cw, X, obs)
    pred, _ = _project(cam_params, pc, bf)  # eager torch: skip the unused Jacobian
    observed = torch.cat([obs.uv, obs.u_right[:, None]], dim=-1)
    r = observed - pred
    is_stereo = obs.u_right >= 0
    ones = torch.ones_like(obs.u_right)
    row_mask = torch.stack(
        [ones, ones, is_stereo.to(torch.float32)], dim=-1
    ) * obs.valid[:, None]
    depth_ok = pc[:, 2] > 1e-3
    return r * row_mask, row_mask, depth_ok


def reproj_jacobians(R_cw, t_cw, X, obs: Observations, cam_params, bf,
                     model: str = "pinhole"):
    """d r / d pose [O,3,6] (xi = (rho, phi) left-mult on T_cw) and
    d r / d X [O,3,3]."""
    Rk, pc = _camera_points(R_cw, t_cw, X, obs)
    _, Jproj = project_with_jac(cam_params, pc, bf, model)
    # d pc / d xi = [I | -hat(pc)]; d r = -Jproj @ d pc
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -lie.hat(pc)], dim=-1)  # [O,3,6]
    return -(Jproj @ dpc_dxi), -(Jproj @ Rk)


def huber_weight(chi2, delta2):
    """IRLS weight of the Huber kernel on squared error:
    1 if chi2 <= delta2 else delta/sqrt(chi2)."""
    return torch.where(
        chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12))
    )
