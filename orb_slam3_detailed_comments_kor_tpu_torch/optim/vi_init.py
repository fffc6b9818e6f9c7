"""Visual-inertial initialization: gravity / scale / bias / velocity solve.

Port of ``orb_slam3_detailed_comments_kor_tpu/optim/vi_init.py``
(``Optimizer::InertialOptimization``, ``src/Optimizer.cc:4686``, driven by
``LocalMapping::InitializeIMU``, ``src/LocalMapping.cc:1566``): with the
visual keyframe poses held fixed, solve for a shared gyro and accelerometer
bias, per-keyframe world velocities, the gravity direction (2 DoF) and,
for monocular maps, a global scale. The problem is small (9 + 3K) and
dense: LM with a forward-mode Jacobian of all residuals, evaluated in
float64 (``jacfwd64``) and rounded to float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops.ransac import jacfwd64
from orb_slam3_detailed_comments_kor_tpu_torch.optim.vi_ba import InertialEdges, inertial_residual
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class VIInitResult(NamedTuple):
    bias_g: torch.Tensor   # [3]
    bias_a: torch.Tensor   # [3]
    v: torch.Tensor        # [K,3]
    gravity: torch.Tensor  # [3] estimated world gravity (magnitude g_mag)
    scale: torch.Tensor    # scalar
    chi2: torch.Tensor     # final cost


def _unpack(theta, b1, b2, g0_unit, g_mag, estimate_scale):
    K = (theta.shape[0] - 9) // 3
    g = lie.so3_exp(theta[6] * b1 + theta[7] * b2) @ g0_unit * g_mag
    s = torch.exp(theta[8]) if estimate_scale else torch.ones((), dtype=theta.dtype, device=theta.device)
    return theta[0:3], theta[3:6], g, s, theta[9:].reshape(K, 3)


def _residuals(theta, R_bw, t_bw, edges, b1, b2, g0_unit, g_mag, estimate_scale):
    bg, ba, g, s, v = _unpack(theta, b1, b2, g0_unit, g_mag, estimate_scale)
    # scaled positions: p' = s·p → t_bw' = s·t_bw (rotation unchanged)
    t_s = s * t_bw
    i, j = edges.i, edges.j
    E = i.shape[0]
    r = inertial_residual(R_bw[i], t_s[i], v[i], bg.expand(E, 3), ba.expand(E, 3),
                          R_bw[j], t_s[j], v[j], edges, g.expand(E, 3))
    return torch.where(edges.valid[:, None], r, 0.0)


def inertial_optimization(R_bw, t_bw, edges: InertialEdges, g0, g_mag: float = 9.81,
                          iters: int = 20, estimate_scale: bool = False,
                          prior_g_info: float = 1e2, prior_a_info: float = 1e5) -> VIInitResult:
    """Solve {bg, ba, v, gravity direction[, scale]} with the poses fixed.

    R_bw/t_bw [K] body poses (world→body); edges: the preintegration chain;
    g0: the initial world gravity guess."""
    K = R_bw.shape[0]
    dev, dt_ = t_bw.device, t_bw.dtype
    D = 9 + 3 * K
    g0_unit = g0 / torch.linalg.vector_norm(g0)
    # orthonormal basis perpendicular to g0
    e = torch.eye(3, dtype=dt_, device=dev)
    a = torch.where(torch.abs(g0_unit[0]) < 0.9, e[0], e[1])
    b1 = torch.linalg.cross(g0_unit, a)
    b1 = b1 / torch.linalg.vector_norm(b1)
    b2 = torch.linalg.cross(g0_unit, b1)

    # initial velocities: finite differences of positions over the edges
    p = -(R_bw.transpose(-1, -2) @ t_bw[..., None])[..., 0]
    dp = (p[edges.j] - p[edges.i]) / torch.clamp(edges.dt[:, None], min=1e-3)
    v0 = torch.zeros((K, 3), dtype=dt_, device=dev)
    v0[edges.i] = dp
    v0[edges.j[-1:]] = dp[-1:]

    args = (R_bw, t_bw, edges, b1, b2, g0_unit, g_mag, estimate_scale)
    Pm = torch.cat([torch.full((3,), prior_g_info, dtype=dt_, device=dev),
                    torch.full((3,), prior_a_info, dtype=dt_, device=dev),
                    torch.zeros((D - 6,), dtype=dt_, device=dev)])
    # without a scale the step's scale entry is set to 0
    keep = torch.arange(D, device=dev) != (D if estimate_scale else 8)

    def cost_of(theta):
        r = _residuals(theta, *args)
        c = torch.sum(torch.einsum("ei,eij,ej->e", r, edges.info9, r))
        # bias priors (priorG=1e2, priorA=1e5 at first init: with little
        # rotation, acc bias and gravity direction are nearly degenerate)
        c = c + prior_g_info * torch.sum(theta[0:3] ** 2)
        return c + prior_a_info * torch.sum(theta[3:6] ** 2)

    theta = torch.cat([torch.zeros((9,), dtype=dt_, device=dev), v0.reshape(-1)])
    lam = torch.full((), 1e-4, dtype=dt_, device=dev)
    best = cost_of(theta)
    eyeD = torch.eye(D, dtype=dt_, device=dev)
    for _ in range(iters):
        r = _residuals(theta, *args)
        J = jacfwd64(_residuals, theta, *args)  # [E,9,D]
        JtWJ = torch.einsum("eid,eij,ejc->dc", J, edges.info9, J)
        JtWr = torch.einsum("eid,eij,ej->d", J, edges.info9, r)
        H = JtWJ + torch.diag(Pm)
        bvec = -JtWr - Pm * theta
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
        Hn = H / d[:, None] / d[None, :] + lam * eyeD
        dth = torch.where(keep, torch.linalg.solve_ex(Hn, bvec / d)[0] / d, 0.0)
        theta_new = theta + dth
        c_new = cost_of(theta_new)
        accept = c_new < best
        theta = torch.where(accept, theta_new, theta)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best = torch.where(accept, c_new, best)
    bg, ba, g, s, v = _unpack(theta, b1, b2, g0_unit, g_mag, estimate_scale)
    return VIInitResult(bias_g=bg, bias_a=ba, v=v, gravity=g, scale=s, chi2=best)
