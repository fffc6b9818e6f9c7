"""Essential-graph pose optimization (loop correction back-end).

Port of ``PoseGraphEdges``, ``make_edges_from_poses``,
``optimize_pose_graph_se3``, ``optimize_pose_graph_sim3`` and
``optimize_pose_graph_4dof`` from
``orb_slam3_detailed_comments_kor_tpu/optim/pose_graph.py``
(``Optimizer::OptimizeEssentialGraph``): relative pose measurements over
the essential graph (spanning tree + strong covisibility + loop edges)
spread a loop's discrepancy over the trajectory. LM over batched edge
residuals with a dense [D·K] solve:
- SE(3): r = log(T_meas⁻¹ ∘ T_i ∘ T_j⁻¹) ∈ R⁶ (stereo / RGB-D);
- Sim(3): 7-D with a per-keyframe scale (monocular);
- 4-DoF: the SE(3) residual with each keyframe free only in yaw about
  gravity and in translation (inertial maps).

Edge Jacobians come from forward-mode differentiation, per edge, as the
reference's ``vmap(jacfwd)``. The normal equations are accumulated with
``index_put_(accumulate=True)``, which adds each entry's contributions in
edge order on every device, as the reference's sequential scan does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops.ransac import jacfwd64
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int
    j: torch.Tensor       # [E] int
    R_meas: torch.Tensor  # [E,3,3] measured T_ij = T_i ∘ T_j⁻¹ (cw frames)
    t_meas: torch.Tensor  # [E,3]
    s_meas: torch.Tensor  # [E] relative scale (1 for SE3 edges)
    weight: torch.Tensor  # [E] information weight
    valid: torch.Tensor   # [E] bool


def make_edges_from_poses(i, j, R_cw, t_cw, weight=None) -> PoseGraphEdges:
    """Measure relative poses from the current estimates."""
    i = i.to(torch.int64)
    j = j.to(torch.int64)
    Rji, tji = lie.se3_inverse(R_cw[j], t_cw[j])
    R_ij, t_ij = lie.se3_compose(R_cw[i], t_cw[i], Rji, tji)
    E = i.shape[0]
    dev = R_cw.device
    return PoseGraphEdges(
        i=i, j=j, R_meas=R_ij, t_meas=t_ij,
        s_meas=torch.ones((E,), dtype=R_cw.dtype, device=dev),
        weight=torch.ones((E,), dtype=R_cw.dtype, device=dev) if weight is None else weight,
        valid=torch.ones((E,), dtype=torch.bool, device=dev),
    )


def _edge_jacobians(edge_residual, D, edges, *state):
    """Residuals [E,r] at zero and their Jacobians [E,r,2D] in the edges'
    two local updates; invalid edges give zeros, NaNs become 0."""
    E = edges.i.shape[0]
    dt_ = edges.t_meas.dtype
    x0 = torch.zeros((E, 2 * D), dtype=dt_, device=edges.t_meas.device)
    per_edge = [a[edges.i] for a in state] + [a[edges.j] for a in state] + [
        edges.R_meas, edges.t_meas, edges.s_meas]
    r = edge_residual(x0, *per_edge)
    J = torch.func.vmap(lambda x, *a: jacfwd64(edge_residual, x, *a))(x0, *per_edge)
    ok = edges.valid[:, None]
    r = torch.where(ok, torch.nan_to_num(r), 0.0)
    J = torch.where(ok[..., None], torch.nan_to_num(J), 0.0)
    return r, J


def _lm_solve(r, J, edges, fixed, lam, K, D):
    """One damped, Jacobi-scaled solve of the pose graph's normal
    equations: dx [K, D]."""
    dev, dt_ = r.device, r.dtype
    w = edges.weight * edges.valid
    JtWJ = torch.einsum("eir,eis,e->ers", J, J, w)  # [E,2D,2D]
    Jt_r = -torch.einsum("eir,ei,e->er", J, r, w)   # [E,2D]
    dims = torch.arange(2 * D, device=dev)
    kf_of = torch.stack([edges.i, edges.j], dim=-1)  # [E,2]
    g = kf_of[:, (dims >= D).to(torch.int64)] * D + dims % D  # [E,2D] global rows
    KD = K * D
    H = torch.zeros((KD * KD,), dtype=dt_, device=dev)
    H.index_put_(((g[:, :, None] * KD + g[:, None, :]).reshape(-1),), JtWJ.reshape(-1), accumulate=True)
    H = H.view(KD, KD)
    b = torch.zeros((KD,), dtype=dt_, device=dev)
    b.index_put_((g.reshape(-1),), Jt_r.reshape(-1), accumulate=True)
    Hf = H + torch.diag(lam * torch.diagonal(H) + 1e-6)
    fp = fixed[:, None].expand(K, D).reshape(-1)
    Hf = torch.where(fp[:, None] | fp[None, :], 0.0, Hf)
    Hf = Hf + torch.diag(fp.to(dt_))
    b_flat = torch.where(fp, 0.0, b)
    d = torch.sqrt(torch.clamp(torch.diagonal(Hf), min=1e-10))
    return (torch.linalg.solve_ex(Hf / d[:, None] / d[None, :], b_flat / d)[0] / d).view(K, D)


def _lm(state, edges, fixed, iters, D, edge_residual, update):
    """The reference's LM loop: ``iters`` iterations, accept a step when it
    lowers the cost (branchless, on the device)."""
    K = state[0].shape[0]

    def cost(st):
        E = edges.i.shape[0]
        x0 = torch.zeros((E, 2 * D), dtype=edges.t_meas.dtype, device=edges.t_meas.device)
        per_edge = [a[edges.i] for a in st] + [a[edges.j] for a in st] + [
            edges.R_meas, edges.t_meas, edges.s_meas]
        r = torch.where(edges.valid[:, None], torch.nan_to_num(edge_residual(x0, *per_edge)), 0.0)
        return torch.sum(torch.sum(r * r, -1) * edges.weight * edges.valid)

    lam = torch.full((), 1e-4, dtype=state[1].dtype, device=state[1].device)
    best = cost(state)
    for _ in range(iters):
        r, J = _edge_jacobians(edge_residual, D, edges, *state)
        dx = _lm_solve(r, J, edges, fixed, lam, K, D)
        new = update(dx, *state)
        c_new = cost(new)
        accept = c_new < best
        state = tuple(torch.where(accept, a, b) for a, b in zip(new, state))
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best = torch.where(accept, c_new, best)
    return state


def _se3_edge_residual(x, Ri0, ti0, Rj0, tj0, Rm, tm, sm):
    dRi, dti = lie.se3_exp(x[..., :6])
    dRj, dtj = lie.se3_exp(x[..., 6:])
    Ri, ti = lie.se3_compose(dRi, dti, Ri0, ti0)
    Rj, tj = lie.se3_compose(dRj, dtj, Rj0, tj0)
    Rji, tji = lie.se3_inverse(Rj, tj)
    R_ij, t_ij = lie.se3_compose(Ri, ti, Rji, tji)
    Rm_i, tm_i = lie.se3_inverse(Rm, tm)
    Re, te = lie.se3_compose(Rm_i, tm_i, R_ij, t_ij)
    return lie.se3_log(Re, te)


def optimize_pose_graph_se3(R_cw, t_cw, edges: PoseGraphEdges, fixed, iters: int = 15):
    """SE(3) pose graph: minimize Σ w‖log(T_meas⁻¹ T_i T_j⁻¹)‖².
    R_cw/t_cw [K]; fixed [K] bool (held). Returns (R_cw', t_cw')."""
    def update(dx, R, t):
        dR, dt = lie.se3_exp(dx)
        return dR @ R, (dR @ t[..., None])[..., 0] + dt

    R, t = _lm((R_cw, t_cw), edges, fixed, iters, 6, _se3_edge_residual, update)
    return lie.project_to_so3(R), t


def _sim3_edge_residual(x, Ri0, ti0, si0, Rj0, tj0, sj0, Rm, tm, sm):
    def local(xi):
        return lie.so3_exp(xi[..., :3]), xi[..., 3:6], torch.exp(xi[..., 6])

    Ri, ti, si = lie.sim3_compose(*local(x[..., :7]), Ri0, ti0, si0)
    Rj, tj, sj = lie.sim3_compose(*local(x[..., 7:]), Rj0, tj0, sj0)
    Rji, tji, sji = lie.sim3_inverse(Rj, tj, sj)
    R_ij, t_ij, s_ij = lie.sim3_compose(Ri, ti, si, Rji, tji, sji)
    Rm_i, tm_i, sm_i = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rm_i, tm_i, sm_i, R_ij, t_ij, s_ij)
    # decoupled residual [log R | t | log s]
    return torch.cat([lie.so3_log(Re), te, torch.log(se)[..., None]], dim=-1)


def optimize_pose_graph_sim3(R_cw, t_cw, s_cw, edges: PoseGraphEdges, fixed, iters: int = 15):
    """Sim(3) essential graph (monocular): per-keyframe 7-DoF states
    absorb scale drift around a loop. Returns (R', t', s')."""
    def update(dx, R, t, s):
        dR = lie.so3_exp(dx[:, :3])
        ds = torch.exp(dx[:, 6])
        return dR @ R, ds[:, None] * (dR @ t[..., None])[..., 0] + dx[:, 3:6], ds * s

    R, t, s = _lm((R_cw, t_cw, s_cw), edges, fixed, iters, 7, _sim3_edge_residual, update)
    return lie.project_to_so3(R), t, s


def _apply_local_4dof(xi, R, t, g_unit):
    """xi = [psi, dp(3)]: a world-side yaw about gravity, then a shift of
    the camera centre: T_cw' = T_cw ∘ W⁻¹, c' = W c + dp."""
    W = lie.so3_exp(xi[..., 0:1] * g_unit)
    R2 = R @ W.transpose(-1, -2)
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    c2 = (W @ c[..., None])[..., 0] + xi[..., 1:]
    return R2, -(R2 @ c2[..., None])[..., 0]


def _4dof_edge_residual(x, Ri0, ti0, gi, Rj0, tj0, gj, Rm, tm, sm):
    Ri, ti = _apply_local_4dof(x[..., :4], Ri0, ti0, gi)
    Rj, tj = _apply_local_4dof(x[..., 4:], Rj0, tj0, gj)
    Rji, tji = lie.se3_inverse(Rj, tj)
    R_ij, t_ij = lie.se3_compose(Ri, ti, Rji, tji)
    Rm_i, tm_i = lie.se3_inverse(Rm, tm)
    Re, te = lie.se3_compose(Rm_i, tm_i, R_ij, t_ij)
    return lie.se3_log(Re, te)


def optimize_pose_graph_4dof(R_cw, t_cw, g_dir, edges: PoseGraphEdges, fixed, iters: int = 15):
    """4-DoF essential graph (``OptimizeEssentialGraph4DoF``,
    ``Optimizer.cc:7523``): inertial maps observe roll, pitch and scale
    through gravity, so a loop correction may move each keyframe only by a
    yaw about the world gravity direction ``g_dir`` and a translation of its
    camera centre. Full 6-D SE(3) edge residual. Returns (R', t')."""
    K = R_cw.shape[0]
    g_unit = (g_dir / torch.linalg.vector_norm(g_dir)).expand(K, 3)

    def update(dx, R, t, g):
        R2, t2 = _apply_local_4dof(dx, R, t, g)
        return R2, t2, g

    R, t, _ = _lm((R_cw, t_cw, g_unit), edges, fixed, iters, 4, _4dof_edge_residual, update)
    return lie.project_to_so3(R), t
