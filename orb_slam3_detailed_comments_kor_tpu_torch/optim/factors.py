"""Reprojection factors: residuals + analytic Jacobians, batched.

Port of ``orb_slam3_detailed_comments_kor_tpu/optim/factors.py``. Poses
are world-to-camera (R_cw, t_cw) with the left-multiplicative update
T_cw <- exp(xi)·T_cw, xi = (rho, phi); the residual is observed -
predicted; stereo rows carry u_right and residual row 2 is
u_r - (u - bf/z), masked for mono rows. A calibrated two-camera rig
(dual fisheye) adds one right-camera row per left row (``with_rig_rows``):
an independent 2-DoF residual through the rig extrinsic, the analog of the
reference's ToBody edges (``include/OptimizableTypes.h:31-145``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

# chi2 gates at 95% for 2/3 DoF (reference Optimizer.cc:905-908)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Observations(NamedTuple):
    """Flat observation table (the device-side edge list). ``cam`` marks
    the rig camera of a row (0 left, 1 right); None means all left."""

    kf: torch.Tensor          # [O] int64 keyframe index
    lm: torch.Tensor          # [O] int64 landmark index
    uv: torch.Tensor          # [O,2] float32 observed pixel
    u_right: torch.Tensor     # [O] float32 observed right-u; <0 -> mono
    inv_sigma2: torch.Tensor  # [O] float32 information scale (1/sigma^2)
    valid: torch.Tensor       # [O] bool
    cam: Optional[torch.Tensor] = None  # [O] int32 rig camera id

    @property
    def n(self) -> int:
        return self.kf.shape[0]


def _pinhole(cam_params, pc, bf):
    """Pinhole + stereo row: pc [O,3] -> (pred [O,3] = (u, v, u_r), 1/z)."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    x, y = pc[..., 0], pc[..., 1]
    zi = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    return torch.stack([u, v, u - bf * zi], dim=-1), zi


def _project(cam_params, pc, bf, model="pinhole"):
    """pc [O,3] -> pred [O,3] = (u, v, u_r). For other models than the
    pinhole the stereo row repeats u: their rows are mono (u_right < 0
    masks it), as in the reference."""
    if model == "pinhole":
        return _pinhole(cam_params, pc, bf)[0]
    uv = camera.project(cam_params, pc, model)
    return torch.cat([uv, uv[..., :1]], dim=-1)


def project_with_jac(cam_params, pc, bf, model: str = "pinhole"):
    """pc [O,3] -> (pred [O,3] = (u, v, u_r), J [O,3,3] = d pred / d pc)."""
    if model != "pinhole":
        Juv = camera.project_jac(cam_params, pc, model)
        return _project(cam_params, pc, bf, model), torch.cat([Juv, Juv[..., :1, :]], dim=-2)
    fx, fy = cam_params[0], cam_params[1]
    x, y = pc[..., 0], pc[..., 1]
    pred, zi = _pinhole(cam_params, pc, bf)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row_v = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    row_r = torch.stack([fx * zi, zero, -fx * x * zi2 + bf * zi2], dim=-1)
    return pred, torch.stack([row_u, row_v, row_r], dim=-2)


def with_rig_rows(obs: Observations, uvr_flat) -> Observations:
    """Append one right-camera row per left row (the ToBody edges).

    uvr_flat [O,2]: the matched right-camera pixel of each left row, x < 0
    for none. The right rows take the left rows' kf, lm and inv_sigma2 (the
    left keypoint's octave weight, the reference's approximation of
    ``Optimizer.cc``'s ToBody edges, which weight by the right keypoint's
    own octave), u_right -1 (mono) and ``cam`` 1.
    """
    n = obs.n
    dev = obs.uv.device
    return Observations(
        kf=obs.kf.repeat(2),
        lm=obs.lm.repeat(2),
        uv=torch.cat([obs.uv, uvr_flat]),
        u_right=torch.full((2 * n,), -1.0, device=dev),
        inv_sigma2=obs.inv_sigma2.repeat(2),
        valid=torch.cat([obs.valid, obs.valid & (uvr_flat[:, 0] >= 0)]),
        cam=torch.cat([torch.zeros((n,), dtype=torch.int32, device=dev),
                       torch.ones((n,), dtype=torch.int32, device=dev)]),
    )


def _rig_points(obs: Observations, pc, rig):
    """(pc_r, is_r): the rows' points in the right camera and the rows
    that camera observes, or (None, None) without a rig."""
    if rig is None or obs.cam is None:
        return None, None
    R_rl, t_rl, _ = rig
    return pc @ R_rl.T + t_rl, obs.cam == 1


def _rig_predict(obs, pc, cam_params, bf, model, rig):
    """Per-row prediction through its rig camera (pc are LEFT-camera
    points); returns (pred [O,3], z [O] of the observing camera)."""
    pred = _project(cam_params, pc, bf, model)
    pc_r, is_r = _rig_points(obs, pc, rig)
    if pc_r is None:
        return pred, pc[:, 2]
    pred_r = _project(rig[2], pc_r, bf, model)
    return torch.where(is_r[:, None], pred_r, pred), torch.where(is_r, pc_r[:, 2], pc[:, 2])


def _rig_select(obs: Observations, pc, cam_params, bf, model, rig):
    """Per-row projection and Jacobian through its rig camera, for a
    calibrated two-camera rig = (R_rl, t_rl, cam_params_r).

    pc [O,3] are LEFT-camera points. Returns (pred [O,3], J [O,3,3] with
    respect to the LEFT-camera point -- the R_rl chain folded in -- and z
    [O] of the observing camera)."""
    pred_l, J_l = project_with_jac(cam_params, pc, bf, model)
    pc_r, is_r = _rig_points(obs, pc, rig)
    if pc_r is None:
        return pred_l, J_l, pc[:, 2]
    R_rl, _, params_r = rig
    pred_r, J_r = project_with_jac(params_r, pc_r, bf, model)
    J_r = J_r @ R_rl  # d pc_r / d pc_l = R_rl
    return (torch.where(is_r[:, None], pred_r, pred_l), torch.where(is_r[:, None, None], J_r, J_l),
            torch.where(is_r, pc_r[:, 2], pc[:, 2]))


def _camera_points(R_cw, t_cw, X, obs: Observations):
    Rk = R_cw[obs.kf]
    return Rk, (Rk @ X[obs.lm][..., None])[..., 0] + t_cw[obs.kf]


def reproj_residuals(R_cw, t_cw, X, obs: Observations, cam_params, bf,
                     model: str = "pinhole", rig=None):
    """Residuals + per-row validity.

    R_cw [K,3,3], t_cw [K,3], X [L,3]; ``rig`` = (R_rl, t_rl,
    cam_params_r) projects the rows with ``obs.cam == 1`` through the
    right camera. Returns (r [O,3], row_mask [O,3] float, depth_ok [O] bool).
    """
    _, pc = _camera_points(R_cw, t_cw, X, obs)
    pred, z = _rig_predict(obs, pc, cam_params, bf, model, rig)  # eager torch: no unused Jacobian
    observed = torch.cat([obs.uv, obs.u_right[:, None]], dim=-1)
    r = observed - pred
    is_stereo = obs.u_right >= 0
    ones = torch.ones_like(obs.u_right)
    row_mask = torch.stack(
        [ones, ones, is_stereo.to(torch.float32)], dim=-1
    ) * obs.valid[:, None]
    depth_ok = z > 1e-3
    return r * row_mask, row_mask, depth_ok


def reproj_jacobians(R_cw, t_cw, X, obs: Observations, cam_params, bf,
                     model: str = "pinhole", rig=None):
    """d r / d pose [O,3,6] (xi = (rho, phi) left-mult on T_cw) and
    d r / d X [O,3,3]."""
    Rk, pc = _camera_points(R_cw, t_cw, X, obs)
    _, Jproj, _ = _rig_select(obs, pc, cam_params, bf, model, rig)
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
