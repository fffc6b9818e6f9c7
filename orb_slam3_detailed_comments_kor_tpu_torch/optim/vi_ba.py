"""Visual-inertial bundle adjustment: 15-state keyframes, preintegration
factors and bias random walks, with Schur landmark elimination.

Port of ``orb_slam3_detailed_comments_kor_tpu/optim/vi_ba.py``
(``Optimizer::LocalInertialBA``, ``src/Optimizer.cc:3959-4686``, and
``FullInertialBA``, ``Optimizer.cc:397``; g2o's ``EdgeInertial`` and
``EdgeGyroRW/AccRW``). State per keyframe: [ξ_pose(6) | v(3) | bg(3) |
ba(3)] = 15, pose T_bw (world→body) with left-multiplicative se(3)
updates, velocity in the world frame. Reprojection factors act on the pose
through the fixed camera-from-body extrinsic T_cb; inertial factors join
consecutive keyframes through the 9-D preintegration residual (Forster),
whitened by the inverse preintegration covariance.

Reprojection Jacobians are analytic; the inertial edges' Jacobians come
from forward-mode differentiation per edge, as the reference's
``vmap(jacfwd)``, evaluated in float64 (``jacfwd64``) and rounded to
float32. ``vi_bundle_adjust`` solves the dense [15K x 15K] reduced system,
``vi_bundle_adjust_cg`` the same model matrix-free by block-Jacobi PCG,
over ``ba.Shards`` of the visual table (one block here, several in
``parallel/dist_vi_ba``).

Every sum over observations or edges is ``index_add_`` on the CPU, which
adds in row order, and a segmented scan on the card (``ba._segment_sum``),
whose float atomics would otherwise land in no fixed order: two runs of
one solve on the same inputs give the same bits. Solves are ``inv_ex`` /
``solve_ex`` and accept/reject is ``torch.where``, so nothing reads the
device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, factors
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import Observations
from orb_slam3_detailed_comments_kor_tpu_torch.ops.ransac import jacfwd64
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class InertialEdges(NamedTuple):
    """Preintegration factors between keyframe pairs (usually (k, k+1))."""

    i: torch.Tensor      # [E] int source kf
    j: torch.Tensor      # [E] int target kf
    dt: torch.Tensor     # [E]
    dR: torch.Tensor     # [E,3,3]
    dV: torch.Tensor     # [E,3]
    dP: torch.Tensor     # [E,3]
    info9: torch.Tensor  # [E,9,9] inverse preintegration covariance
    JRg: torch.Tensor    # [E,3,3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias_g0: torch.Tensor  # [E,3] linearization biases
    bias_a0: torch.Tensor  # [E,3]
    valid: torch.Tensor    # [E] bool


#: covariance floor (standard deviations) added when edges are built: f32
#: normal equations cannot hold the raw preintegration information
COV_FLOOR = (5e-4, 5e-4, 5e-4, 2e-3, 2e-3, 2e-3, 1e-3, 1e-3, 1e-3)
WALK_INFO_CAP = 1e6


@functools.lru_cache(maxsize=None)
def floor_cov(device, cov_floor=COV_FLOOR) -> torch.Tensor:
    """diag(cov_floor²) [9,9] on ``device``, made once per device (a fresh
    host-to-device copy per solve would wait on the host)."""
    return torch.diag(torch.tensor(cov_floor, dtype=torch.float32) ** 2).to(device)


@functools.lru_cache(maxsize=None)
def _l24(device):
    """local-24 → (which keyframe of the edge, state dim) maps:
    [ξi(6) vi(3) bgi(3) bai(3) | ξj(6) vj(3)]."""
    is_j = torch.cat([torch.zeros(15, dtype=torch.int64), torch.ones(9, dtype=torch.int64)])
    dim = torch.cat([torch.arange(15), torch.arange(6), torch.arange(6, 9)])
    return is_j.to(device), dim.to(device)


def edge_info(cov, cov_floor=COV_FLOOR):
    """inv(cov + floor²) per edge [E,9,9]."""
    return torch.linalg.inv_ex(cov + floor_cov(cov.device, tuple(cov_floor)))[0]


def make_edges(pres, i_idx, j_idx, cov_floor=COV_FLOOR) -> InertialEdges:
    """InertialEdges from a list of Preintegrated (host-side helper)."""
    dev = pres[0].dR.device
    st = lambda name: torch.stack([getattr(p, name) for p in pres])
    return InertialEdges(
        i=torch.as_tensor(i_idx, dtype=torch.int64).to(dev),
        j=torch.as_tensor(j_idx, dtype=torch.int64).to(dev),
        dt=st("dt"), dR=st("dR"), dV=st("dV"), dP=st("dP"),
        info9=edge_info(st("cov"), cov_floor),
        JRg=st("JRg"), JVg=st("JVg"), JVa=st("JVa"), JPg=st("JPg"), JPa=st("JPa"),
        bias_g0=st("bias_g"), bias_a0=st("bias_a"),
        valid=torch.ones((len(pres),), dtype=torch.bool, device=dev),
    )


class VIState(NamedTuple):
    R_bw: torch.Tensor  # [K,3,3] world→body
    t_bw: torch.Tensor  # [K,3]
    v: torch.Tensor     # [K,3] world-frame velocity
    bg: torch.Tensor    # [K,3]
    ba: torch.Tensor    # [K,3]


def _mv(R, x):
    return (R @ x[..., None])[..., 0]


def inertial_residual(R_bw_i, t_bw_i, v_i, bg_i, ba_i, R_bw_j, t_bw_j, v_j, e, gravity):
    """9-D residual [r_R, r_v, r_p] (``EdgeInertial::computeError``,
    ``src/G2oTypes.cc:517``), batched over leading dims. ``e`` holds the
    edges' preintegration fields (an ``InertialEdges`` whose arrays line up
    with the states)."""
    dbg = bg_i - e.bias_g0
    dba = ba_i - e.bias_a0
    dR = e.dR @ lie.so3_exp(_mv(e.JRg, dbg))
    dV = e.dV + _mv(e.JVg, dbg) + _mv(e.JVa, dba)
    dP = e.dP + _mv(e.JPg, dbg) + _mv(e.JPa, dba)
    dt = e.dt[..., None]
    # p_wb = −R_bwᵀ t_bw
    p_i = -_mv(R_bw_i.transpose(-1, -2), t_bw_i)
    p_j = -_mv(R_bw_j.transpose(-1, -2), t_bw_j)
    r_R = lie.so3_log(dR.transpose(-1, -2) @ R_bw_i @ R_bw_j.transpose(-1, -2))
    r_v = _mv(R_bw_i, v_j - v_i - gravity * dt) - dV
    r_p = _mv(R_bw_i, p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dP
    return torch.cat([r_R, r_v, r_p], dim=-1)


def _edge_residual_from_tangent(x, Ri, ti, Rj, tj, vi, vj, bgi, bai, e, gravity):
    """Residual as a function of the 24-dim tangent perturbation
    [ξi(6), vi(3), bgi(3), bai(3), ξj(6), vj(3)]."""
    dRi, dti = lie.se3_exp(x[..., 0:6])
    dRj, dtj = lie.se3_exp(x[..., 15:21])
    R_i, t_i = dRi @ Ri, _mv(dRi, ti) + dti
    R_j, t_j = dRj @ Rj, _mv(dRj, tj) + dtj
    return inertial_residual(R_i, t_i, vi + x[..., 6:9], bgi + x[..., 9:12], bai + x[..., 12:15],
                             R_j, t_j, vj + x[..., 21:24], e, gravity)


def _edge_inputs(st: VIState, edges: InertialEdges, gravity):
    i, j = edges.i, edges.j
    E = i.shape[0]
    return (st.R_bw[i], st.t_bw[i], st.R_bw[j], st.t_bw[j], st.v[i], st.v[j], st.bg[i], st.ba[i],
            edges, gravity.expand(E, 3))


def inertial_residuals(st: VIState, edges: InertialEdges, gravity):
    """Residuals [E,9] of all edges at the current state (padding edges 0)."""
    x0 = torch.zeros((edges.i.shape[0], 24), dtype=st.t_bw.dtype, device=st.t_bw.device)
    r = _edge_residual_from_tangent(x0, *_edge_inputs(st, edges, gravity))
    return torch.where(edges.valid[:, None], torch.nan_to_num(r), 0.0)


def eval_inertial(st: VIState, edges: InertialEdges, gravity):
    """Residuals [E,9] + Jacobians [E,9,24] of all edges (forward mode)."""
    args = _edge_inputs(st, edges, gravity)
    x0 = torch.zeros((edges.i.shape[0], 24), dtype=st.t_bw.dtype, device=st.t_bw.device)
    r = _edge_residual_from_tangent(x0, *args)
    J = torch.func.vmap(lambda x, *a: jacfwd64(_edge_residual_from_tangent, x, *a))(x0, *args)
    # padding edges can sit at degenerate states whose Jacobian is not
    # finite; 0·NaN would defeat the validity mask downstream
    ok = edges.valid[:, None]
    r = torch.where(ok, torch.nan_to_num(r), 0.0)
    J = torch.where(ok[..., None], torch.nan_to_num(J), 0.0)
    return r, J


def _summer(idx, n: int):
    """Row sums per index in [0, n): ``index_add_`` (row order) on the CPU,
    the deterministic segmented scan on the card. The layout is made once
    per solve; the returned function sums one [O, ...] array."""
    idx = idx.to(torch.int64)
    seg = ba._segments(idx, n) if idx.is_cuda else None

    def add(vals):
        if seg is not None:
            return ba._segment_sum(vals, seg)
        return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)
    return add


def _camera_pose(st, R_cb, t_cb):
    """T_cw = T_cb ∘ T_bw."""
    return R_cb @ st.R_bw, st.t_bw @ R_cb.T + t_cb


def _visual_rows(st, Xc, obs, cam_params, R_cb, t_cb, bf, delta2, cam_model, rig=None):
    """Residuals, IRLS weights and the per-observation Jacobian blocks with
    respect to the body-pose tangent (∂pc/∂ξ_b = R_cb [I | −hat(pb)]) and
    the landmark; a ``rig``'s right rows project through its extrinsic."""
    R_cw, t_cw = _camera_pose(st, R_cb, t_cb)
    r, row_mask, depth_ok = factors.reproj_residuals(R_cw, t_cw, Xc, obs, cam_params, bf, cam_model, rig=rig)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    w = obs.inv_sigma2 * factors.huber_weight(chi2, delta2) * (obs.valid & depth_ok)
    Rk = st.R_bw[obs.kf]
    pb = _mv(Rk, Xc[obs.lm]) + st.t_bw[obs.kf]
    pc = pb @ R_cb.T + t_cb
    _, Jproj, _ = factors._rig_select(obs, pc, cam_params, bf, cam_model, rig)
    eye = torch.eye(3, dtype=pb.dtype, device=pb.device).expand(pb.shape[0], 3, 3)
    dpc_dxi = R_cb @ torch.cat([eye, -lie.hat(pb)], dim=-1)  # [O,3,6]
    Jp = -(Jproj @ dpc_dxi) * row_mask[:, :, None]
    Jl = -(Jproj @ R_cb @ Rk) * row_mask[:, :, None]
    return r, w, Jp, Jl


def _visual_cost(st, Xc, obs, cam_params, R_cb, t_cb, bf, delta2, cam_model, rig=None):
    """Σ robust reprojection cost over ``obs``."""
    R_cw, t_cw = _camera_pose(st, R_cb, t_cb)
    r, _, dok = factors.reproj_residuals(R_cw, t_cw, Xc, obs, cam_params, bf, cam_model, rig=rig)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    return torch.sum(ba._robust_cost(chi2, delta2) * (obs.valid & dok))


def _costs(st, Xc, obs, edges, cam_params, R_cb, t_cb, bf, gravity, delta2, cam_model,
           gyro_walk_info, acc_walk_info, prior_bg_info, prior_ba_info, bg0, ba0, free_kf, rig=None):
    """Total cost: robust reprojection + inertial + bias random walk + bias
    priors."""
    c_vis = _visual_cost(st, Xc, obs, cam_params, R_cb, t_cb, bf, delta2, cam_model, rig)
    return _plus_inertial_costs(c_vis, st, edges, gravity, gyro_walk_info, acc_walk_info, prior_bg_info,
                                prior_ba_info, bg0, ba0, free_kf)


def _plus_inertial_costs(c_vis, st, edges, gravity, gyro_walk_info, acc_walk_info, prior_bg_info,
                         prior_ba_info, bg0, ba0, free_kf):
    """c_vis + the inertial, bias random walk and bias prior costs."""
    r_in = inertial_residuals(st, edges, gravity)
    c_in = torch.sum(torch.einsum("ei,eij,ej->e", r_in, edges.info9, r_in) * edges.valid)
    dbg = st.bg[edges.j] - st.bg[edges.i]
    dba = st.ba[edges.j] - st.ba[edges.i]
    dtc = torch.clamp(edges.dt, min=1e-3)
    w_g, w_a = gyro_walk_info / dtc, acc_walk_info / dtc
    c_rw = torch.sum((w_g * torch.sum(dbg * dbg, -1) + w_a * torch.sum(dba * dba, -1)) * edges.valid)
    c_pr = (prior_bg_info * torch.sum((st.bg - bg0) ** 2 * free_kf[:, None])
            + prior_ba_info * torch.sum((st.ba - ba0) ** 2 * free_kf[:, None]))
    return c_vis + c_in + c_rw + c_pr


def _step(stc, Xc, dx, dl):
    dRb, dtb = lie.se3_exp(dx[:, 0:6])
    st_new = VIState(
        R_bw=dRb @ stc.R_bw, t_bw=_mv(dRb, stc.t_bw) + dtb,
        v=stc.v + dx[:, 6:9], bg=stc.bg + dx[:, 9:12], ba=stc.ba + dx[:, 12:15],
    )
    return st_new, Xc + dl


def _inertial_blocks(stc, edges, gravity, w_edge):
    """Per edge JᵀΩJ [E,24,24] and −JᵀΩr [E,24]."""
    r_in, J_in = eval_inertial(stc, edges, gravity)
    Jw = J_in * w_edge[:, None, None]
    JtW = Jw.transpose(1, 2) @ (edges.info9 @ J_in)
    Jt_r = -(Jw.transpose(1, 2) @ _mv(edges.info9, r_in)[..., None])[..., 0]
    return JtW, Jt_r


def vi_bundle_adjust(
    st: VIState, X, obs: Observations, edges: InertialEdges, fixed_kf, fixed_point,
    cam_params, R_cb, t_cb, bf: float, gravity, gyro_walk_info: float, acc_walk_info: float,
    prior_bg_info=0.0, prior_ba_info=0.0, iters: int = 10, fix_scale: bool = True,
    cam_model: str = "pinhole", rig=None,
):
    """Joint VI-LM over K keyframes (15-dim each) and L landmarks with a
    dense Schur complement. obs.kf indexes the K keyframes; bias random-walk
    factors couple each edge's two biases; ``prior_bg_info`` /
    ``prior_ba_info`` pull each free keyframe's bias toward its value at call
    time (the bFIBA priors, ``Optimizer.cc:397``). Returns (VIState, X,
    costs [iters+1])."""
    K, L, P = st.R_bw.shape[0], X.shape[0], 15
    KP = K * P
    dev, dt_ = X.device, X.dtype
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    delta2 = torch.where(obs.u_right >= 0, factors.CHI2_STEREO, factors.CHI2_MONO)
    free_kf = (~fixed_kf).to(dt_)
    free_l = (~fixed_point).to(dt_)
    bg0, ba0 = st.bg, st.ba
    kf, lm = obs.kf.to(torch.int64), obs.lm.to(torch.int64)
    obs = obs._replace(kf=kf, lm=lm)
    w_edge = edges.valid.to(dt_)
    cost = functools.partial(
        _costs, obs=obs, edges=edges, cam_params=cam_params, R_cb=R_cb, t_cb=t_cb, bf=bf,
        gravity=gravity, delta2=delta2, cam_model=cam_model, gyro_walk_info=gyro_walk_info,
        acc_walk_info=acc_walk_info, prior_bg_info=prior_bg_info, prior_ba_info=prior_ba_info,
        bg0=bg0, ba0=ba0, free_kf=free_kf, rig=rig)

    # ---- the solve's fixed sum layouts ----------------------------------
    sum_kf, sum_lm, sum_pl = _summer(kf, K), _summer(lm, L), _summer(kf * L + lm, K * L)
    is_j, ldim = _l24(dev)
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    g = torch.stack([ei, ej], -1)[:, is_j] * P + ldim  # [E,24] flat state rows
    # S entries: the edges' JᵀΩJ blocks, then per walk (gyro, acc) the
    # ii, jj, ij, ji diagonals; b entries: Jᵀr, then per walk i and j
    d3 = torch.arange(3, device=dev)
    rw_rows = [(ei[:, None] * P + d0 + d3, ej[:, None] * P + d0 + d3) for d0 in (9, 12)]
    s_idx = [(g[:, :, None] * KP + g[:, None, :]).reshape(-1)]
    b_idx = [g.reshape(-1)]
    for ri, rj in rw_rows:
        s_idx += [(ri * KP + ri).reshape(-1), (rj * KP + rj).reshape(-1),
                  (ri * KP + rj).reshape(-1), (rj * KP + ri).reshape(-1)]
        b_idx += [ri.reshape(-1), rj.reshape(-1)]
    sum_S, sum_b = _summer(torch.cat(s_idx), KP * KP), _summer(torch.cat(b_idx), KP)
    kk = torch.arange(K, device=dev)
    prior_diag = torch.zeros((P,), dtype=dt_, device=dev)
    prior_diag = torch.cat([prior_diag[:9], prior_diag[9:12] + prior_bg_info, prior_diag[12:] + prior_ba_info])
    fp = fixed_kf[:, None].expand(K, P).reshape(-1)

    stc, Xc = st, X
    lam = torch.full((), 1e-4, dtype=dt_, device=dev)
    best = cost(stc, Xc)
    costs = [best]
    for _ in range(iters):
        # ---- visual part, lifted into the 15-dim system -----------------
        r, w, Jp, Jl = _visual_rows(stc, Xc, obs, cam_params, R_cb, t_cb, bf, delta2, cam_model, rig)
        Jp = Jp * free_kf[kf][:, None, None]
        Jl = Jl * free_l[lm][:, None, None]
        JpT, JlT = Jp.transpose(1, 2), Jl.transpose(1, 2)
        w3 = w[:, None, None]
        Hpp6 = sum_kf(w3 * (JpT @ Jp))
        Hll = sum_lm(w3 * (JlT @ Jl))
        bp6 = sum_kf(-w[:, None] * (JpT @ r[..., None])[..., 0])
        bl = sum_lm(-w[:, None] * (JlT @ r[..., None])[..., 0])
        Wpl = sum_pl(w3 * (JpT @ Jl)).view(K, L, 6, 3).permute(0, 2, 1, 3)  # [K,6,L,3]

        tr3 = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
        Hll_d = Hll + lam * eye3[None] * (tr3[:, None, None] / 3.0 + 1e-3)
        Hll_d = torch.where(fixed_point[:, None, None], eye3[None], Hll_d)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
        W2 = Wpl.reshape(K * 6, L * 3)
        Y2 = (W2.view(K * 6, L, 1, 3) @ Hll_inv).reshape(K * 6, L * 3)
        S6 = -(Y2 @ W2.T).view(K, 6, K, 6)
        S6[kk, :, kk, :] += Hpp6
        b6 = bp6 - (Y2 @ bl.reshape(-1)).view(K, 6)
        S = torch.zeros((K, P, K, P), dtype=dt_, device=dev)
        S[:, 0:6, :, 0:6] = S6
        b = torch.zeros((K, P), dtype=dt_, device=dev)
        b[:, 0:6] = b6

        # ---- inertial edges and bias random walks -----------------------
        JtW, Jt_r = _inertial_blocks(stc, edges, gravity, w_edge)
        dtc = torch.clamp(edges.dt, min=1e-3)
        s_vals, b_vals = [JtW.reshape(-1)], [Jt_r.reshape(-1)]
        for wi, d0, bias in ((gyro_walk_info, 9, stc.bg), (acc_walk_info, 12, stc.ba)):
            w3e = (wi / dtc * w_edge)[:, None].expand(-1, 3)
            db = bias[ej] - bias[ei]
            s_vals += [w3e.reshape(-1), w3e.reshape(-1), -w3e.reshape(-1), -w3e.reshape(-1)]
            b_vals += [(w3e * db).reshape(-1), (-w3e * db).reshape(-1)]
        S = S.view(-1) + sum_S(torch.cat(s_vals))
        b = b.view(-1) + sum_b(torch.cat(b_vals))

        # ---- bias priors (bFIBA): gradient + diagonal information -------
        b = b.view(K, P)
        b = torch.cat([b[:, :9], b[:, 9:12] - prior_bg_info * (stc.bg - bg0),
                       b[:, 12:] - prior_ba_info * (stc.ba - ba0)], dim=1)
        Sf = S.view(KP, KP) + torch.diag(prior_diag.repeat(K))

        # ---- damping, fixing, Jacobi-scaled solve ------------------------
        Sf = Sf + torch.diag(lam * torch.diagonal(Sf) + 1e-6)
        Sf = torch.where(fp[:, None] | fp[None, :], 0.0, Sf)
        Sf = Sf + torch.diag(fp.to(dt_))
        b_flat = torch.where(fp, 0.0, b.reshape(-1))
        d = torch.sqrt(torch.clamp(torch.diagonal(Sf), min=1e-10))
        dx = (torch.linalg.solve_ex(Sf / d[:, None] / d[None, :], b_flat / d)[0] / d).view(K, P)
        rhs = bl - (W2.T @ dx[:, 0:6].reshape(-1)).view(L, 3)
        dl = (Hll_inv @ rhs[..., None])[..., 0] * free_l[:, None]

        st_new, X_new = _step(stc, Xc, dx, dl)
        cost_new = cost(st_new, X_new)
        accept = (cost_new < best) & torch.isfinite(dx).all() & torch.isfinite(dl).all()
        stc = VIState(*(torch.where(accept, n, o) for n, o in zip(st_new, stc)))
        Xc = torch.where(accept, X_new, Xc)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best = torch.where(accept, cost_new, best)
        costs.append(cost_new)
    stc = stc._replace(R_bw=lie.project_to_so3(stc.R_bw))
    return stc, Xc, torch.stack(costs)


def vi_bundle_adjust_cg(
    st: VIState, X, obs: Observations, edges: InertialEdges, fixed_kf, fixed_point,
    cam_params, R_cb, t_cb, bf: float, gravity, gyro_walk_info: float, acc_walk_info: float,
    prior_bg_info=0.0, prior_ba_info=0.0, iters: int = 8, cg_iters: int = 24,
    cam_model: str = "pinhole", rig=None,
):
    """Whole-map VI LM: the model of :func:`vi_bundle_adjust` with
    matrix-free Schur landmark elimination and block-Jacobi PCG on the
    [K,15] reduced system, so K and L can be map-capacity sized (memory
    O(obs + E·576 + K·225)). Returns (VIState, X, costs [iters+1])."""
    kf, lm = obs.kf.to(torch.int64), obs.lm.to(torch.int64)
    stc, Xc, costs = _vi_bundle_adjust_cg_shards(
        st, X, ba.Shards.single(obs._replace(kf=kf, lm=lm)), edges, fixed_kf, fixed_point, cam_params,
        R_cb, t_cb, bf, gravity, gyro_walk_info, acc_walk_info, prior_bg_info, prior_ba_info, iters,
        cg_iters, cam_model, rig)
    return stc, Xc, torch.stack(costs)


def _vi_bundle_adjust_cg_shards(st, X, shards, edges, fixed_kf, fixed_point, cam_params, R_cb, t_cb, bf,
                                gravity, gyro_walk_info, acc_walk_info, prior_bg_info, prior_ba_info, iters,
                                cg_iters, cam_model, rig):
    """``vi_bundle_adjust_cg``'s LM over a visual table in ``shards``
    (int64 index columns): each shard sums its reprojection blocks and
    ``shards.reduce`` adds them; the inertial chain, the bias random walks
    and priors and the PCG are computed once, on the state's device.
    Returns (VIState, X, the costs of each iteration)."""
    K, L, P = st.R_bw.shape[0], X.shape[0], 15
    dev, dt_ = X.device, X.dtype
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eyeP = torch.eye(P, dtype=dt_, device=dev)
    delta2s = [torch.where(o.u_right >= 0, factors.CHI2_STEREO, factors.CHI2_MONO) for o in shards.obs]
    free_kf = (~fixed_kf).to(dt_)
    free_l = (~fixed_point).to(dt_)
    bg0, ba0 = st.bg, st.ba
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    w_edge = edges.valid.to(dt_)
    cams, rigs, R_cbs, t_cbs, free_kfs, free_ls = (
        shards.put(x) for x in (cam_params, rig, R_cb, t_cb, free_kf, free_l))
    rows = [ba.ShardRows(o.kf, o.lm, _summer(o.kf, K), _summer(o.lm, L)) for o in shards.obs]
    sum_i, sum_j = _summer(ei, K), _summer(ej, K)
    is_j, _ = _l24(dev)
    free24 = free_kf[torch.stack([ei, ej], -1)[:, is_j]]  # [E,24]
    rw_fi, rw_fj = free_kf[ei], free_kf[ej]
    pr = torch.cat([torch.zeros((9,), dtype=dt_, device=dev),
                    torch.zeros((3,), dtype=dt_, device=dev) + prior_bg_info,
                    torch.zeros((3,), dtype=dt_, device=dev) + prior_ba_info])
    E = ei.shape[0]

    def cost(stc, Xc):
        c_vis = shards.reduce([
            _visual_cost(s_, X_, o, cam, Rc, tc, bf, d2, cam_model, rg)
            for o, d2, cam, rg, Rc, tc, (s_, X_) in zip(shards.obs, delta2s, cams, rigs, R_cbs, t_cbs,
                                                        shards.put((stc, Xc)))])
        return _plus_inertial_costs(c_vis, stc, edges, gravity, gyro_walk_info, acc_walk_info, prior_bg_info,
                                    prior_ba_info, bg0, ba0, free_kf)

    def pad(block, r0, c0):
        """A [E, a, b] block placed at (r0, c0) of [E, P, P] zeros."""
        a, c = block.shape[1], block.shape[2]
        return torch.nn.functional.pad(block, (c0, P - c0 - c, r0, P - r0 - a))

    def diag_rows(vals, d0):
        """[E, 3] values at dims d0..d0+2 of [E, P]."""
        return torch.nn.functional.pad(vals, (d0, P - d0 - 3))

    stc, Xc = st, X
    lam = torch.full((), 1e-4, dtype=dt_, device=dev)
    best = cost(stc, Xc)
    costs = [best]
    for _ in range(iters):
        # ---- visual blocks (body-pose tangent, dims 0:6) ----------------
        sums, A = [], []
        for o, d2, rw, cam, rg, Rc, tc, fks, fls, (s_, X_) in zip(
                shards.obs, delta2s, rows, cams, rigs, R_cbs, t_cbs, free_kfs, free_ls, shards.put((stc, Xc))):
            r, w, Jp, Jl = _visual_rows(s_, X_, o, cam, Rc, tc, bf, d2, cam_model, rg)
            JpT, JlT = Jp.transpose(1, 2), Jl.transpose(1, 2)
            w3 = w[:, None, None]
            sums.append((rw.sum_kf(w3 * (JpT @ Jp)), rw.sum_lm(w3 * (JlT @ Jl)),
                         rw.sum_kf(-w[:, None] * (JpT @ r[..., None])[..., 0]),
                         rw.sum_lm(-w[:, None] * (JlT @ r[..., None])[..., 0])))
            A.append((w * fks[rw.kf] * fls[rw.lm])[:, None, None] * (JpT @ Jl))  # [O,6,3]
        Hpp6, Hll, bp6, bl = shards.reduce(sums)
        bp6 = bp6 * free_kf[:, None]
        bl = bl * free_l[:, None]
        tr3 = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
        Hll_d = Hll + lam * eye3[None] * (tr3[:, None, None] / 3.0 + 1e-3)
        Hll_d = torch.where(fixed_point[:, None, None], eye3[None], Hll_d)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]

        # ---- inertial edge blocks, fixed keyframes zeroed at the source ---
        JtW, Jt_r = _inertial_blocks(stc, edges, gravity, w_edge)
        JtW = JtW * free24[:, :, None] * free24[:, None, :]
        Jt_r = Jt_r * free24
        dtc = torch.clamp(edges.dt, min=1e-3)
        w_g = gyro_walk_info / dtc * w_edge
        w_a = acc_walk_info / dtc * w_edge
        walks = ((9, w_g, stc.bg[ej] - stc.bg[ei]), (12, w_a, stc.ba[ej] - stc.ba[ei]))

        # ---- RHS --------------------------------------------------------
        y0 = (Hll_inv @ bl[..., None])[..., 0]
        Wy0 = ba._w(shards, rows, A, y0)
        rows_i = Jt_r[:, 0:15]
        rows_j = torch.nn.functional.pad(Jt_r[:, 15:24], (0, P - 9))
        for d0, wgt, db in walks:
            rows_i = rows_i + diag_rows((wgt * rw_fi)[:, None] * db, d0)
            rows_j = rows_j - diag_rows((wgt * rw_fj)[:, None] * db, d0)
        b = torch.nn.functional.pad(bp6 - Wy0, (0, P - 6)) + sum_i(rows_i) + sum_j(rows_j)
        # bias prior gradient (zero until a step was accepted)
        b = torch.cat([b[:, :9], b[:, 9:12] - prior_bg_info * (stc.bg - bg0),
                       b[:, 12:] - prior_ba_info * (stc.ba - ba0)], dim=1)
        b = torch.where(fixed_kf[:, None], 0.0, b)

        # ---- diagonal blocks (preconditioner + damping target) ----------
        Di, Dj = JtW[:, 0:15, 0:15], pad(JtW[:, 15:24, 15:24], 0, 0)
        for d0, wgt, _ in walks:
            Di = Di + torch.diag_embed(diag_rows((wgt * rw_fi)[:, None].expand(E, 3), d0))
            Dj = Dj + torch.diag_embed(diag_rows((wgt * rw_fj)[:, None].expand(E, 3), d0))
        D = pad(Hpp6, 0, 0) + sum_i(Di) + sum_j(Dj) + torch.diag(pr)[None]
        diagD = torch.diagonal(D, dim1=-2, dim2=-1)
        D_d = D + lam * torch.diag_embed(diagD) + 1e-6 * eyeP[None]
        D_d = torch.where(fixed_kf[:, None, None], eyeP[None], D_d)
        JtW_ij = JtW[:, 0:15, 15:24]  # [E,15,9]

        def matvec(v):
            """S·v for v [K,P]: the visual Schur part on dims 0:6 plus the
            inertial and walk couplings."""
            y = (Hll_inv @ ba._wt(shards, rows, A, v[:, 0:6])[..., None])[..., 0]
            Wy = ba._w(shards, rows, A, y)
            Sv = (D_d @ v[..., None])[..., 0] - torch.nn.functional.pad(Wy, (0, P - 6))
            vi, vj = v[ei], v[ej]
            ri = (JtW_ij @ vj[:, 0:9, None])[..., 0]
            rj = torch.nn.functional.pad((JtW_ij.transpose(1, 2) @ vi[:, 0:15, None])[..., 0], (0, P - 9))
            for d0, wgt, _ in walks:
                wf = (wgt * rw_fi * rw_fj)[:, None]
                ri = ri - diag_rows(wf * vj[:, d0:d0 + 3], d0)
                rj = rj - diag_rows(wf * vi[:, d0:d0 + 3], d0)
            Sv = Sv + sum_i(ri) + sum_j(rj)
            return torch.where(fixed_kf[:, None], v, Sv)

        Minv = torch.linalg.inv_ex(D_d)[0]
        dx = ba._pcg(matvec, b, Minv, cg_iters) * free_kf[:, None]
        u = ba._wt(shards, rows, A, dx[:, 0:6])
        dl = (Hll_inv @ (bl - u)[..., None])[..., 0] * free_l[:, None]

        st_new, X_new = _step(stc, Xc, dx, dl)
        cost_new = cost(st_new, X_new)
        accept = (cost_new < best) & torch.isfinite(dx).all() & torch.isfinite(dl).all()
        stc = VIState(*(torch.where(accept, n, o) for n, o in zip(st_new, stc)))
        Xc = torch.where(accept, X_new, Xc)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best = torch.where(accept, cost_new, best)
        costs.append(cost_new)
    stc = stc._replace(R_bw=lie.project_to_so3(stc.R_bw))
    return stc, Xc, costs
