"""Motion-only bundle adjustment (``Optimizer::PoseOptimization`` analog).

Port of ``pose_optimization`` from
``orb_slam3_detailed_comments_kor_tpu/optim/ba.py`` (the path with no pose
prior and no camera rig): Levenberg-Marquardt on one pose against fixed
3-D points, ``rounds`` x ``iters`` iterations with chi2 inlier re-gating
between rounds and the Huber kernel dropped after round 2. Accept/reject
is branchless (``torch.where``) and the 6x6 solve is ``solve_ex`` without
error checks, so the loop never waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import (
    CHI2_MONO,
    CHI2_STEREO,
    Observations,
)
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


def _robust_cost(chi2, delta2):
    """Huber rho on squared error (for accept/reject decisions)."""
    return torch.where(
        chi2 <= delta2, chi2,
        2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2,
    )


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inlier: torch.Tensor     # [O] bool final inlier set
    n_inliers: torch.Tensor  # scalar


def pose_optimization(
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    u_right: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    rounds: int = 4,
    iters: int = 10,
    prior=None,
    cam_model: str = "pinhole",
) -> PoseOptResult:
    """Optimize one pose against fixed points X [N,3], one observation each
    (uv/u_right/inv_sigma2/valid [N])."""
    if prior is not None:
        raise NotImplementedError("pose priors are not ported")
    n = X.shape[0]
    dev = X.device
    obs = Observations(
        kf=torch.zeros((n,), dtype=torch.int64, device=dev),
        lm=torch.arange(n, device=dev),
        uv=uv,
        u_right=u_right,
        inv_sigma2=inv_sigma2,
        valid=valid,
    )
    delta2 = torch.where(u_right >= 0, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=X.dtype, device=dev)

    def residual(R, t, active):
        return factors.reproj_residuals(
            R[None], t[None], X, obs._replace(valid=active), cam_params, bf,
            cam_model,
        )

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    def cost_of(chi2, mask, use_huber):
        c = _robust_cost(chi2, delta2) if use_huber else chi2
        return torch.sum(c * mask)

    R, t, inlier = R_cw, t_cw, valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        r0, _, dok0 = residual(R, t, inlier & valid)
        best_cost = cost_of(chi2_of(r0), inlier & valid & dok0, use_huber)
        lam = torch.full((), 1e-3, dtype=X.dtype, device=dev)  # no host copy
        for _ in range(iters):
            active = inlier & valid
            r, row_mask, depth_ok = residual(R, t, active)
            active = active & depth_ok
            chi2 = chi2_of(r)
            w_h = factors.huber_weight(chi2, delta2) if use_huber else 1.0
            w = inv_sigma2 * w_h * active
            Jp, _ = factors.reproj_jacobians(
                R[None], t[None], X, obs, cam_params, bf, cam_model
            )
            Jp = Jp * row_mask[:, :, None]
            # H = Σ w·JᵀJ and b = -Σ w·Jᵀr as two [6, 3·O] matmuls
            Jw = (Jp * w[:, None, None]).reshape(-1, 6).T
            H = Jw @ Jp.reshape(-1, 6)
            b = -(Jw @ r.reshape(-1))
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            delta = torch.linalg.solve_ex(Hd, b)[0]
            dR, dt = lie.se3_exp(delta)
            R_new = dR @ R
            t_new = dR @ t + dt
            r2, _, dok2 = residual(R_new, t_new, active)
            cost_new = cost_of(chi2_of(r2), active & dok2, use_huber)
            accept = cost_new < best_cost
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lam = torch.where(accept, lam * 0.33, lam * 3.0)
            best_cost = torch.where(accept, cost_new, best_cost)
        # re-gate inliers on the FULL observation set (outliers can recover)
        r1, _, dok1 = residual(R, t, valid)
        inlier = (chi2_of(r1) <= delta2) & valid & dok1
    R = lie.project_to_so3(R)
    return PoseOptResult(R, t, inlier, torch.sum(inlier))
