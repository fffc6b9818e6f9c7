"""Per-frame visual-inertial state optimization with a marginal prior.

Port of ``orb_slam3_detailed_comments_kor_tpu/optim/vio.py``
(``Optimizer::PoseInertialOptimizationLastKeyFrame`` / ``LastFrame``,
``Optimizer.cc:6697,7092``): at frame rate, the current frame's full
15-dim state (body pose, velocity, gyro and accelerometer bias) is
optimized jointly with the previous state against the reprojection of the
frame's matched map points, the IMU preintegration factor, bias random
walks and the previous state's marginal prior (``ConstraintPoseImu``,
``G2oTypes.h:703-783``); the previous state is then marginalized out by
Schur complement into the next frame's prior. One fixed-iteration 30-dim
Gauss-Newton; the small residuals' Jacobian comes from forward-mode
differentiation in float64 (``jacfwd64``). Solves and factorizations are
``solve_ex`` / ``cholesky_ex`` / ``inv_ex``, so a frame never waits on the
device.

The chi² regate lags one iteration and lets rejected observations back in
(the reference's fault F7, kept for parity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import imu as imu_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops.ransac import jacfwd64
from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors, vi_ba
from orb_slam3_detailed_comments_kor_tpu_torch.optim.ba import _robust_cost
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import CHI2_MONO, CHI2_STEREO, Observations
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class VioState(NamedTuple):
    """One body state: world→body pose, velocity and biases."""

    R_bw: torch.Tensor  # [3,3]
    t_bw: torch.Tensor  # [3]
    v: torch.Tensor     # [3] world-frame velocity
    bg: torch.Tensor    # [3]
    ba: torch.Tensor    # [3]


class VioPrior(NamedTuple):
    """Marginal prior on one state: information at a linearization point.
    Tangent order: [ξ(6: θ,t left-mult), v(3), bg(3), ba(3)]."""

    H: torch.Tensor  # [15,15]
    state: VioState


def strong_prior(state: VioState, pose_info: float = 1e6, vel_info: float = 1e4,
                 bias_info: float = 1e4) -> VioPrior:
    """Prior standing in for a FIXED previous state (the LastKeyFrame
    variant fixes the keyframe vertex, ``Optimizer.cc:6697``)."""
    dev, dt_ = state.t_bw.device, state.t_bw.dtype
    d = torch.cat([torch.full((6,), pose_info, dtype=dt_, device=dev),
                   torch.full((3,), vel_info, dtype=dt_, device=dev),
                   torch.full((6,), bias_info, dtype=dt_, device=dev)])
    return VioPrior(H=torch.diag(d), state=state)


def _mv(R, x):
    return (R @ x[..., None])[..., 0]


def _state_residual_15(x15, st: VioState, ref: VioState):
    """15-dim residual of a perturbed state against a reference state:
    [se3_log(T(x)·T̄⁻¹), v−v̄, bg−b̄g, ba−b̄a]."""
    dR, dt = lie.se3_exp(x15[0:6])
    R = dR @ st.R_bw
    t = _mv(dR, st.t_bw) + dt
    Rr_i, tr_i = lie.se3_inverse(ref.R_bw, ref.t_bw)
    Rd, td = lie.se3_compose(R, t, Rr_i, tr_i)
    return torch.cat([lie.se3_log(Rd, td), st.v + x15[6:9] - ref.v,
                      st.bg + x15[9:12] - ref.bg, st.ba + x15[12:15] - ref.ba])


def _inertial_residual_30(x30, prev: VioState, cur: VioState, pre: imu_ops.Preintegrated, gravity):
    """EdgeInertial's 9-dim residual (``G2oTypes.cc:517``) as a function of
    the 30-dim joint tangent [prev ξ,v,bg,ba | cur ξ,v,bg,ba]."""
    dRp, dtp = lie.se3_exp(x30[0:6])
    Rp, tp = dRp @ prev.R_bw, _mv(dRp, prev.t_bw) + dtp
    vp = prev.v + x30[6:9]
    bgp = prev.bg + x30[9:12]
    bap = prev.ba + x30[12:15]
    dRc, dtc = lie.se3_exp(x30[15:21])
    Rc, tc = dRc @ cur.R_bw, _mv(dRc, cur.t_bw) + dtc
    vc = cur.v + x30[21:24]
    dbg = bgp - pre.bias_g
    dba = bap - pre.bias_a
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    dt = pre.dt
    p_p = -_mv(Rp.T, tp)
    p_c = -_mv(Rc.T, tc)
    r_R = lie.so3_log(dR.T @ Rp @ Rc.T)
    r_v = _mv(Rp, vc - vp - gravity * dt) - dV
    r_p = _mv(Rp, p_c - p_p - vp * dt - 0.5 * gravity * dt * dt) - dP
    return torch.cat([r_R, r_v, r_p])


def _small_residuals(x30, prev, cur, ref, Lp, L9, pre, gravity, w_rw):
    """All non-visual residuals, whitened, as one vector [15 + 9 + 6]."""
    r_pr = Lp.T @ _state_residual_15(x30[0:15], prev, ref)
    r_in = L9.T @ _inertial_residual_30(x30, prev, cur, pre, gravity)
    bgp, bap = prev.bg + x30[9:12], prev.ba + x30[12:15]
    bgc, bac = cur.bg + x30[24:27], cur.ba + x30[27:30]
    r_rw = w_rw * torch.cat([bgc - bgp, bac - bap])
    return torch.cat([r_pr, r_in, r_rw])


def _update(st: VioState, dx) -> VioState:
    dR, dt = lie.se3_exp(dx[0:6])
    return VioState(R_bw=dR @ st.R_bw, t_bw=_mv(dR, st.t_bw) + dt, v=st.v + dx[6:9],
                    bg=st.bg + dx[9:12], ba=st.ba + dx[12:15])


def frame_vi_optimize(prior: VioPrior, pre: imu_ops.Preintegrated, cur0: VioState, X, uv, u_right,
                      inv_sigma2, valid, cam_params, R_cb, t_cb, bf: float, gravity,
                      gyro_walk_info: float = 1e4, acc_walk_info: float = 1e3, iters: int = 3,
                      cam_model: str = "pinhole", uv_r=None, rig=None):
    """30-dim joint GN + marginalization. Returns (cur: VioState,
    next_prior: VioPrior, inlier [M] bool, n_inliers).

    X [M,3] matched map points; uv/u_right/inv_sigma2/valid [M] their
    measurements. The previous state and its prior live in ``prior``;
    ``pre`` is the preintegration previous→current. ``uv_r`` [M,2] with a
    ``rig``: the right-camera rows; the inliers returned are the left
    rows', the count covers both."""
    M = X.shape[0]
    dev, dt_ = X.device, X.dtype
    obs = Observations(kf=torch.zeros((M,), dtype=torch.int64, device=dev),
                       lm=torch.arange(M, device=dev), uv=uv, u_right=u_right,
                       inv_sigma2=inv_sigma2, valid=valid)
    Xo = X
    if rig is not None:
        obs = factors.with_rig_rows(obs, uv_r)
        Xo = X[obs.lm]
    delta2 = torch.where(obs.u_right >= 0, CHI2_STEREO, CHI2_MONO)
    eye9 = torch.eye(9, dtype=dt_, device=dev)
    eye15 = torch.eye(15, dtype=dt_, device=dev)
    eye30 = torch.eye(30, dtype=dt_, device=dev)
    info9 = torch.linalg.inv_ex(pre.cov + vi_ba.floor_cov(dev))[0]
    # whitening square roots (Cholesky factors of the informations)
    L9 = torch.linalg.cholesky_ex(0.5 * (info9 + info9.T) + 1e-6 * eye9)[0]
    Lp = torch.linalg.cholesky_ex(0.5 * (prior.H + prior.H.T) + 1e-4 * eye15)[0]
    dtc = torch.clamp(pre.dt, min=1e-3)
    w_rw = torch.cat([torch.sqrt(gyro_walk_info / dtc).expand(3), torch.sqrt(acc_walk_info / dtc).expand(3)])
    consts = (prior.state, Lp, L9, pre, gravity, w_rw)
    eye3 = torch.eye(3, dtype=dt_, device=dev).expand(obs.n, 3, 3)

    def vis_blocks(cur, active):
        """Visual residual and body-pose Jacobian blocks at ``cur``
        (EdgeMono/Stereo through the body pose, ``G2oTypes.h:339``)."""
        R_cw = R_cb @ cur.R_bw
        t_cw = _mv(R_cb, cur.t_bw) + t_cb
        r, row_mask, depth_ok = factors.reproj_residuals(
            R_cw[None], t_cw[None], X, obs._replace(valid=active), cam_params, bf, cam_model, rig=rig)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        w = obs.inv_sigma2 * factors.huber_weight(chi2, delta2) * (active & depth_ok)
        pb = Xo @ cur.R_bw.T + cur.t_bw
        pc = pb @ R_cb.T + t_cb
        _, Jproj, _ = factors._rig_select(obs, pc, cam_params, bf, cam_model, rig)
        dpc_dxi = R_cb @ torch.cat([eye3, -lie.hat(pb)], dim=-1)
        Jp = -(Jproj @ dpc_dxi) * row_mask[:, :, None]
        Jw = (Jp * w[:, None, None]).reshape(-1, 6).T
        Hv = Jw @ Jp.reshape(-1, 6)
        bv = -(Jw @ r.reshape(-1))
        c_vis = torch.sum(_robust_cost(chi2, delta2) * (active & depth_ok))
        return Hv, bv, c_vis, chi2, depth_ok

    def lift(H, b, Hv, bv):
        H = H + torch.nn.functional.pad(Hv, (15, 9, 15, 9))
        return H, (None if b is None else b + torch.nn.functional.pad(bv, (15, 9)))

    x0 = torch.zeros((30,), dtype=dt_, device=dev)
    prev, cur, active = prior.state, cur0, obs.valid
    lam = torch.full((), 1e-3, dtype=dt_, device=dev)
    for _ in range(iters):
        # one visual evaluation serves the step and the (lagged) regate
        Hv, bv, _, chi2, dok = vis_blocks(cur, active)
        r_s = _small_residuals(x0, prev, cur, *consts)
        J_s = jacfwd64(_small_residuals, x0, prev, cur, *consts)  # [30,30]
        H, b = lift(J_s.T @ J_s, -(J_s.T @ r_s), Hv, bv)
        # damped solve with Jacobi scaling (the informations span decades)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye30
        d = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
        dx = torch.linalg.solve_ex(Hd / d[:, None] / d[None, :], b / d)[0] / d
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        prev, cur = _update(prev, dx[0:15]), _update(cur, dx[15:30])
        # the chi² regate for the NEXT iteration, from this one's residuals
        active = obs.valid & dok & (chi2 <= delta2)
        lam = lam * 0.5
    cur = cur._replace(R_bw=lie.project_to_so3(cur.R_bw))

    # ---- marginalize the previous state (ConstraintPoseImu production) ---
    J_s = jacfwd64(_small_residuals, x0, prev, cur, *consts)
    Hv, _, _, _, _ = vis_blocks(cur, active)
    H, _ = lift(J_s.T @ J_s, None, Hv, None)
    Hpp = H[0:15, 0:15] + 1e-6 * eye15
    Hpc = H[0:15, 15:30]
    H_marg = H[15:30, 15:30] - Hpc.T @ torch.linalg.solve_ex(Hpp, Hpc)[0]
    H_marg = 0.5 * (H_marg + H_marg.T)
    H_marg = torch.where(torch.isfinite(H_marg).all(), H_marg, eye15)
    inlier = active if rig is None else active[:M]
    return cur, VioPrior(H=H_marg, state=cur), inlier, torch.sum(active)


def kf_prior(kf_R_cw, kf_t_cw, vel, bg, ba, R_cb, t_cb) -> VioPrior:
    """The LastKeyFrame-variant prior at a keyframe's VI state: the pose
    pinned hard (it comes from bundle adjustment), velocity and bias
    moderately."""
    R_bc, t_bc = lie.se3_inverse(R_cb, t_cb)
    st = VioState(R_bw=R_bc @ kf_R_cw, t_bw=_mv(R_bc, kf_t_cw) + t_bc, v=vel, bg=bg, ba=ba)
    return strong_prior(st, vel_info=1e2, bias_info=1e3)


def vio_frame_step(lm_pos, lm_feat, lm_inlier, frame_xy, frame_u_right, frame_level, frame_uv_r,
                   R_cw_vis, t_cw_vis, prior: VioPrior, pre: imu_ops.Preintegrated, cam_params,
                   R_cb, t_cb, gravity, rig, bf: float, scale: float, cam_model: str = "pinhole",
                   cap: int = 1024, min_inliers: int = 15):
    """Refine the visually tracked frame with the full 15-dim VI state
    (``PoseInertialOptimizationLastFrame`` / ``LastKeyFrame``).

    ``lm_feat/lm_inlier`` [L] map the landmark block to matched features;
    the matched subset is compacted into ``cap`` static slots. Returns
    (R_cw, t_cw, cur: VioState, next_prior: VioPrior, n_vio_inliers); the
    pose falls back to the IMU dead-reckoned state (and the prior to a stiff
    prior at it) when the solve is not finite or has fewer than
    ``min_inliers`` visual inliers (the PredictStateIMU path). With a
    ``rig``, ``frame_uv_r`` adds the right-camera rows."""
    L = lm_feat.shape[0]
    M = cap
    dev = lm_pos.device
    matched = lm_inlier
    slot = torch.clamp(torch.where(matched, torch.cumsum(matched, 0) - 1, M), max=M)
    sel = msx.scatter_drop(torch.zeros((M,), dtype=torch.int64, device=dev), slot,
                           torch.arange(L, device=dev))
    used = msx.scatter_drop(torch.zeros((M,), dtype=torch.bool, device=dev), slot, matched)
    feat = torch.clamp(lm_feat[sel], min=0).to(torch.int64)
    X = lm_pos[sel]
    uv = frame_xy[feat]
    u_right = torch.where(used, frame_u_right[feat], -1.0)
    # 1 / scale ** (2 level), in the form XLA compiles it to: scale ** (-2 level)
    inv_sigma2 = scale ** (-2.0 * frame_level[feat].to(torch.float32))
    uv_r = None if frame_uv_r is None else frame_uv_r[feat]

    # dead-reckoned current state (previous state ∘ preintegration)
    prev = prior.state
    R_wb_p = prev.R_bw.T
    p_wb_p = -_mv(prev.R_bw.T, prev.t_bw)
    R2, p2, v2 = imu_ops.predict_state(pre, R_wb_p, p_wb_p, prev.v, prev.bg, prev.ba, gravity)
    pred = VioState(R_bw=R2.T, t_bw=-_mv(R2.T, p2), v=v2, bg=prev.bg, ba=prev.ba)

    # initial state: the visual pose, the predicted velocity, the carried bias
    R_bc, t_bc = lie.se3_inverse(R_cb, t_cb)
    cur0 = VioState(R_bw=R_bc @ R_cw_vis, t_bw=_mv(R_bc, t_cw_vis) + t_bc, v=v2, bg=prev.bg, ba=prev.ba)
    cur, next_prior, _, n_in = frame_vi_optimize(
        prior, pre, cur0, X, uv, u_right, inv_sigma2, used, cam_params, R_cb, t_cb, bf, gravity,
        cam_model=cam_model, uv_r=uv_r, rig=rig)
    finite = torch.isfinite(cur.t_bw).all() & torch.isfinite(cur.v).all() & torch.isfinite(next_prior.H).all()
    ok = finite & (n_in >= min_inliers)
    cur = VioState(*(torch.where(ok, a, b) for a, b in zip(cur, pred)))
    fallback = strong_prior(pred, pose_info=1e4)
    next_prior = VioPrior(H=torch.where(ok, next_prior.H, fallback.H),
                          state=VioState(*(torch.where(ok, a, b) for a, b in zip(next_prior.state, fallback.state))))
    R_cw = R_cb @ cur.R_bw
    t_cw = _mv(R_cb, cur.t_bw) + t_cb
    return R_cw, t_cw, cur, next_prior, n_in
