"""Inertial keyframe state and the VI local-mapping step.

Port of ``orb_slam3_detailed_comments_kor_tpu/slam/inertial.py``: the
per-keyframe velocity, biases and preintegration from the previous
keyframe (``KeyFrame.h:270-275``), the per-frame IMU pipeline (integrate,
compose, predict), the chain merge that follows keyframe culling, IMU
initialization (``LocalMapping::InitializeIMU``, ``LocalMapping.cc:1566``),
the whole-map FullInertialBA and the windowed local inertial BA
(``Optimizer::LocalInertialBA``). Scatters with duplicate indices keep the
reference's CPU order (``map_state.scatter_last``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import imu as imu_ops
from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors, vi_ba, vi_init
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class InertialKF(NamedTuple):
    """Per-keyframe inertial state, capacity K (parallel to MapState)."""

    vel: torch.Tensor      # [K,3] world velocity
    bg: torch.Tensor       # [K,3]
    ba: torch.Tensor       # [K,3]
    # preintegration from the PREVIOUS keyframe to this one
    pre_dt: torch.Tensor   # [K]
    pre_dR: torch.Tensor   # [K,3,3]
    pre_dV: torch.Tensor   # [K,3]
    pre_dP: torch.Tensor   # [K,3]
    pre_cov: torch.Tensor  # [K,9,9]
    pre_JRg: torch.Tensor  # [K,3,3]
    pre_JVg: torch.Tensor
    pre_JVa: torch.Tensor
    pre_JPg: torch.Tensor
    pre_JPa: torch.Tensor
    pre_bg0: torch.Tensor  # [K,3] linearization bias
    pre_ba0: torch.Tensor
    pre_valid: torch.Tensor  # [K] bool (false for KF0 / after map reset)


#: InertialKF field -> Preintegrated field of the stored window
_PRE_FIELDS = (("pre_dt", "dt"), ("pre_dR", "dR"), ("pre_dV", "dV"), ("pre_dP", "dP"),
               ("pre_cov", "cov"), ("pre_JRg", "JRg"), ("pre_JVg", "JVg"), ("pre_JVa", "JVa"),
               ("pre_JPg", "JPg"), ("pre_JPa", "JPa"), ("pre_bg0", "bias_g"), ("pre_ba0", "bias_a"))


def empty_inertial(max_kf: int, device="cuda") -> InertialKF:
    K = max_kf
    z = lambda *s: torch.zeros((K,) + s, dtype=torch.float32, device=device)
    return InertialKF(
        vel=z(3), bg=z(3), ba=z(3), pre_dt=z(),
        pre_dR=torch.eye(3, device=device).repeat(K, 1, 1),
        pre_dV=z(3), pre_dP=z(3), pre_cov=z(9, 9),
        pre_JRg=z(3, 3), pre_JVg=z(3, 3), pre_JVa=z(3, 3), pre_JPg=z(3, 3), pre_JPa=z(3, 3),
        pre_bg0=z(3), pre_ba0=z(3),
        pre_valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def _set_row(arr, i: int, val):
    """``arr.at[i].set(val)``: an index past the capacity is dropped."""
    if not 0 <= i < arr.shape[0]:
        return arr
    out = arr.clone()
    out[i] = val
    return out


def store_preintegration(ikf: InertialKF, kf_idx: int, pre: imu_ops.Preintegrated, vel) -> InertialKF:
    """The window ending at keyframe ``kf_idx`` and its velocity."""
    i = int(kf_idx)
    upd = {name: _set_row(getattr(ikf, name), i, getattr(pre, f)) for name, f in _PRE_FIELDS}
    return ikf._replace(vel=_set_row(ikf.vel, i, vel), pre_valid=_set_row(ikf.pre_valid, i, pre.dt > 1e-6),
                        **upd)


def pre_at(ikf: InertialKF, idx) -> imu_ops.Preintegrated:
    """The stored windows at ``idx`` as a Preintegrated."""
    return imu_ops.Preintegrated(**{f: getattr(ikf, name)[idx] for name, f in _PRE_FIELDS})


def advance_imu(batch, bg, ba, sigma_g: float, sigma_a: float, pre_run, kf_R_cw, kf_t_cw, vel,
                gravity, R_cb, t_cb):
    """The per-frame IMU pipeline: integrate the frame's sample window,
    fold it into the running since-keyframe composition and dead-reckon
    the camera pose from the last keyframe's VI state. Returns (segment,
    run, R_pred, t_pred, v_pred)."""
    seg = imu_ops.integrate(batch, bg, ba, sigma_g, sigma_a)
    run = imu_ops.compose(pre_run, seg)
    R_pred, t_pred, v2 = predict_from_pre(run, kf_R_cw, kf_t_cw, vel, bg, ba, gravity, R_cb, t_cb)
    return seg, run, R_pred, t_pred, v2


def predict_from_pre(pre: imu_ops.Preintegrated, kf_R_cw, kf_t_cw, vel, bg, ba, gravity, R_cb, t_cb):
    """PredictStateIMU (``Tracking.cc:1561``): the camera pose dead-reckoned
    from a keyframe's VI state through a preintegrated window."""
    R_bc, t_bc = lie.se3_inverse(R_cb, t_cb)
    R_bw_kf = R_bc @ kf_R_cw
    t_bw_kf = R_bc @ kf_t_cw + t_bc
    R_wb = R_bw_kf.T
    p_wb = -R_bw_kf.T @ t_bw_kf
    R2, p2, v2 = imu_ops.predict_state(pre, R_wb, p_wb, vel, bg, ba, gravity)
    R_bw2 = R2.T
    t_bw2 = -R2.T @ p2
    R_pred, t_pred = lie.se3_compose(R_cb, t_cb, R_bw2, t_bw2)
    return R_pred, t_pred, v2


def merge_and_compact(ikf: InertialKF, keep) -> InertialKF:
    """Inertial counterpart of keyframe culling and slot compaction.

    keep [K]: validity BEFORE compaction (the surviving keyframes; the slot
    arithmetic of ``map_state.compact_keyframes``). A culled keyframe's
    window flows into its successor's (closed-form composition, ``imu.compose``;
    the reference's ``MergePrevious`` on the raw measurements)."""
    K = keep.shape[0]
    dev = keep.device
    new_of_old = torch.where(keep, torch.cumsum(keep, 0) - 1, K)
    src = msx.scatter_drop(torch.zeros((K,), dtype=torch.int64, device=dev), new_of_old,
                           torch.arange(K, device=dev))
    mask = torch.arange(K, device=dev) < torch.sum(keep)
    slots = pre_at(ikf, slice(None))
    acc = imu_ops.identity_preintegrated(dev)
    acc_valid = torch.zeros((), dtype=torch.bool, device=dev)
    merged, merged_valid = [], []
    for k in range(K):
        pre_k = imu_ops.Preintegrated(*(a[k] for a in slots))
        keep_k = keep[k]
        total = imu_ops.compose(acc, pre_k)
        v_total = acc_valid | ikf.pre_valid[k]
        merged.append(total)
        merged_valid.append(v_total)
        # a culled slot's window flows into the accumulator; a kept slot
        # emits the accumulated window and resets the accumulator
        ident = imu_ops.identity_preintegrated(dev)._replace(bias_g=pre_k.bias_g, bias_a=pre_k.bias_a)
        acc = imu_ops.Preintegrated(*(torch.where(keep_k, i2, t) for t, i2 in zip(total, ident)))
        acc_valid = v_total & ~keep_k
    merged = imu_ops.Preintegrated(*(torch.stack(a) for a in zip(*merged)))
    merged_valid = torch.stack(merged_valid)

    def take(a):
        return torch.where(mask.reshape((K,) + (1,) * (a.dim() - 1)), a[src], torch.zeros_like(a))

    out = {name: take(getattr(merged, f)) for name, f in _PRE_FIELDS}
    out["pre_dR"] = torch.where(mask[:, None, None], merged.dR[src], torch.eye(3, device=dev)[None])
    return InertialKF(vel=take(ikf.vel), bg=take(ikf.bg), ba=take(ikf.ba),
                      pre_valid=take(merged_valid) & mask, **out)


def _edges(ikf: InertialKF, ks, i, j, valid, cov_floor=vi_ba.COV_FLOOR) -> vi_ba.InertialEdges:
    """Edges whose windows are the stored ones at slots ``ks``."""
    pre = pre_at(ikf, ks)
    return vi_ba.InertialEdges(
        i=i, j=j, dt=pre.dt, dR=pre.dR, dV=pre.dV, dP=pre.dP, info9=vi_ba.edge_info(pre.cov, cov_floor),
        JRg=pre.JRg, JVg=pre.JVg, JVa=pre.JVa, JPg=pre.JPg, JPa=pre.JPa,
        bias_g0=pre.bias_g, bias_a0=pre.bias_a, valid=valid,
    )


def edges_for_range(ikf: InertialKF, first: int, last: int, cov_floor=vi_ba.COV_FLOOR) -> vi_ba.InertialEdges:
    """Edges (k-1, k) for k in (first, last] from the stored windows;
    info = inv(cov + floor²)."""
    dev = ikf.vel.device
    ks = torch.arange(first + 1, last + 1, device=dev)
    return _edges(ikf, ks, ks - 1, ks, ikf.pre_valid[ks], cov_floor)


def _body_poses(R_cw, t_cw, R_cb, t_cb):
    """T_bw = T_bc ∘ T_cw = inv(T_cb) ∘ T_cw."""
    R_bc, t_bc = lie.se3_inverse(R_cb, t_cb)
    return R_bc @ R_cw, t_cw @ R_bc.T + t_bc


def initialize_imu(ms: msx.MapState, ikf: InertialKF, n_kf: int, g0, R_cb, t_cb,
                   estimate_scale: bool = False):
    """IMU init over the whole keyframe chain: gravity, biases, velocities
    (and the metric scale for monocular input) with the visual poses fixed,
    written into the inertial block. Returns (ikf', gravity [3], scale)."""
    edges = edges_for_range(ikf, 0, n_kf - 1)
    R_bw, t_bw = _body_poses(ms.kf_R_cw[:n_kf], ms.kf_t_cw[:n_kf], R_cb, t_cb)
    res = vi_init.inertial_optimization(R_bw, t_bw, edges, g0, iters=25, prior_g_info=1e2,
                                        prior_a_info=1e5, estimate_scale=estimate_scale)
    head = lambda new, old: torch.cat([new, old[n_kf:]])
    ikf = ikf._replace(
        vel=head(res.v, ikf.vel),
        bg=head(res.bias_g.expand(n_kf, 3), ikf.bg),
        ba=head(res.bias_a.expand(n_kf, 3), ikf.ba),
    )
    return ikf, res.gravity, res.scale


def build_fiba_problem(ms: msx.MapState, ikf: InertialKF, R_cb, t_cb, rig=None):
    """FullInertialBA problem: whole-map masked Observations, the
    consecutive-chain InertialEdges, the body-frame VIState and the fixed
    masks; with a ``rig``, one right-camera row per feature slot. Returns
    (st, obs, edges, fixed_kf, fixed_point)."""
    K, N = ms.K, ms.N
    dev = ms.obs_lm.device
    obs_rows = ms.obs_lm
    feat_ok = ms.kf_feat_valid & (obs_rows >= 0) & ms.kf_valid[:, None]
    # 1 / 1.2 ** (2 level), in the form XLA compiles it to: 1.2 ** (-2 level)
    inv_s2 = 1.2 ** (-2.0 * ms.kf_level.to(torch.float32))
    obs = factors.Observations(
        kf=torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1),
        lm=torch.clamp(obs_rows, min=0).to(torch.int64).reshape(-1),
        uv=ms.kf_xy.reshape(-1, 2),
        u_right=ms.kf_ur.reshape(-1),
        inv_sigma2=inv_s2.reshape(-1),
        valid=feat_ok.reshape(-1),
    )
    if rig is not None:
        obs = factors.with_rig_rows(obs, ms.kf_uvr.reshape(-1, 2))
    ks = torch.arange(1, K, device=dev)
    edges = _edges(ikf, ks, ks - 1, ks, ikf.pre_valid[ks] & ms.kf_valid[ks] & ms.kf_valid[ks - 1])
    R_bw, t_bw = _body_poses(ms.kf_R_cw, ms.kf_t_cw, R_cb, t_cb)
    st = vi_ba.VIState(R_bw=R_bw, t_bw=t_bw, v=ikf.vel, bg=ikf.bg, ba=ikf.ba)
    fixed_kf = ~ms.kf_valid | (torch.arange(K, device=dev) == 0)
    return st, obs, edges, fixed_kf, ~ms.lm_valid


def apply_fiba_result(ms: msx.MapState, ikf: InertialKF, st_f, X_f, fixed_kf, R_cb, t_cb):
    """Write a VI-BA result back into the map and inertial blocks (free
    keyframes only)."""
    R_cw_new = R_cb @ st_f.R_bw
    t_cw_new = st_f.t_bw @ R_cb.T + t_cb
    upd = ~fixed_kf
    ms = ms._replace(
        kf_R_cw=torch.where(upd[:, None, None], R_cw_new, ms.kf_R_cw),
        kf_t_cw=torch.where(upd[:, None], t_cw_new, ms.kf_t_cw),
        lm_pos=torch.where(ms.lm_valid[:, None], X_f, ms.lm_pos),
    )
    ikf = ikf._replace(
        vel=torch.where(upd[:, None], st_f.v, ikf.vel),
        bg=torch.where(upd[:, None], st_f.bg, ikf.bg),
        ba=torch.where(upd[:, None], st_f.ba, ikf.ba),
    )
    return ms, ikf


def full_inertial_ba(ms: msx.MapState, ikf: InertialKF, gravity, cam_params, R_cb, t_cb, bf: float,
                     prior_bg_info=0.0, prior_ba_info=0.0, iters: int = 8, cam_model: str = "pinhole",
                     rig=None):
    """Whole-map visual-inertial BA (``Optimizer::FullInertialBA``,
    ``src/Optimizer.cc:397``) by matrix-free PCG Schur: reprojection, the
    preintegration chain and bias random walks over all valid keyframes.
    Returns (ms', ikf', cost)."""
    st, obs, edges, fixed_kf, fixed_point = build_fiba_problem(ms, ikf, R_cb, t_cb, rig=rig)
    st_f, X_f, costs = vi_ba.vi_bundle_adjust_cg(
        st, ms.lm_pos, obs, edges, fixed_kf, fixed_point, cam_params, R_cb, t_cb, bf, gravity,
        gyro_walk_info=vi_ba.WALK_INFO_CAP, acc_walk_info=vi_ba.WALK_INFO_CAP,
        prior_bg_info=prior_bg_info, prior_ba_info=prior_ba_info, iters=iters, cam_model=cam_model,
        rig=rig,
    )
    ms, ikf = apply_fiba_result(ms, ikf, st_f, X_f, fixed_kf, R_cb, t_cb)
    return ms, ikf, costs[-1]


def local_vi_ba_step(ms: msx.MapState, ikf: InertialKF, center_kf: int, gravity, cam_params, R_cb, t_cb,
                     bf: float, window: int = 10, lm_cap: int = 2048, iters: int = 6, scale: float = 1.2,
                     cam_model: str = "pinhole", rig=None, prior_bg_info=0.0, prior_ba_info=0.0):
    """Sliding temporal-window local inertial BA (``LocalInertialBA``: the
    last ``window`` consecutive keyframes, [center-window+1, center]) with
    the landmark compaction of ``local_ba_step`` and the oldest valid
    keyframe fixed. With ``window >= n_kf`` and bias priors it is the
    whole-map FullInertialBA in its dense-Schur form (the bFIBA call).
    A ``rig`` adds the right-camera rows. Returns (ms, ikf, final_cost);
    nothing reads the device."""
    K, N, L = ms.K, ms.N, ms.L
    dev = ms.lm_pos.device
    ww = torch.arange(window, device=dev)
    win = int(center_kf) - (window - 1) + ww  # ascending, may be negative
    win_ok = win >= 0
    win = torch.clamp(win, min=0)
    win_ok = win_ok & ms.kf_valid[win]

    # ---- landmark compaction over the window ----------------------------
    obs_rows = ms.obs_lm[win]
    feat_ok = ms.kf_feat_valid[win] & (obs_rows >= 0) & win_ok[:, None]
    lm_hit = torch.zeros((L + 1,), dtype=torch.bool, device=dev)  # slot L parks
    lm_hit.index_fill_(0, torch.where(feat_ok, obs_rows, L).reshape(-1).to(torch.int64), True)
    lm_hit = lm_hit[:L] & ms.lm_valid
    local_of_global = torch.where(lm_hit, torch.cumsum(lm_hit, 0) - 1, lm_cap)
    overflow = local_of_global >= lm_cap
    local_of_global = torch.where(overflow, lm_cap, local_of_global)
    # slot lm_cap of both parks the landmarks outside the block
    global_of_local = torch.zeros((lm_cap + 1,), dtype=torch.int64, device=dev)
    global_of_local[local_of_global] = torch.arange(L, device=dev)
    lm_used = torch.zeros((lm_cap + 1,), dtype=torch.bool, device=dev)
    lm_used[local_of_global] = lm_hit & ~overflow
    gol, used = global_of_local[:lm_cap], lm_used[:lm_cap]
    X_local = ms.lm_pos[gol]
    lm_local = local_of_global[torch.clamp(obs_rows, min=0).to(torch.int64)]
    obs_valid = feat_ok & (lm_local < lm_cap)
    # 1 / scale ** (2 level), in the form XLA compiles it to: scale ** (-2 level)
    inv_s2 = scale ** (-2.0 * ms.kf_level[win].to(torch.float32))
    obs = factors.Observations(
        kf=ww[:, None].expand(window, N).reshape(-1),
        lm=torch.clamp(lm_local, 0, lm_cap - 1).reshape(-1),
        uv=ms.kf_xy[win].reshape(-1, 2),
        u_right=ms.kf_ur[win].reshape(-1),
        inv_sigma2=inv_s2.reshape(-1),
        valid=obs_valid.reshape(-1),
    )
    if rig is not None:
        obs = factors.with_rig_rows(obs, ms.kf_uvr[win].reshape(-1, 2))
    # inertial edges between consecutive window slots
    edges = _edges(ikf, win[1:], ww[:-1], ww[1:], ikf.pre_valid[win[1:]] & win_ok[1:] & win_ok[:-1])
    R_bw, t_bw = _body_poses(ms.kf_R_cw[win], ms.kf_t_cw[win], R_cb, t_cb)
    st = vi_ba.VIState(R_bw=R_bw, t_bw=t_bw, v=ikf.vel[win], bg=ikf.bg[win], ba=ikf.ba[win])
    # fix the oldest valid keyframe of the window (the temporal anchor)
    first_ok = torch.argmax(win_ok.to(torch.uint8))
    fixed = (ww == first_ok) | ~win_ok

    st_f, X_f, costs = vi_ba.vi_bundle_adjust(
        st, X_local, obs, edges, fixed, ~used, cam_params, R_cb, t_cb, bf, gravity,
        gyro_walk_info=vi_ba.WALK_INFO_CAP, acc_walk_info=vi_ba.WALK_INFO_CAP,
        prior_bg_info=prior_bg_info, prior_ba_info=prior_ba_info, iters=iters, cam_model=cam_model,
        rig=rig,
    )

    # ---- write back: T_cw = T_cb ∘ T_bw, inertial states, landmarks ------
    # (the clamped window repeats slot 0: the reference's CPU scatter keeps
    # the last write of each slot, as scatter_last does)
    R_cw_new = R_cb @ st_f.R_bw
    t_cw_new = st_f.t_bw @ R_cb.T + t_cb
    upd = win_ok & ~fixed

    def put(arr, new, u=upd):
        keep = u.reshape((window,) + (1,) * (new.dim() - 1))
        return msx.scatter_last(arr, win, torch.where(keep, new, arr[win]))

    ms = ms._replace(
        kf_R_cw=put(ms.kf_R_cw, R_cw_new),
        kf_t_cw=put(ms.kf_t_cw, t_cw_new),
        lm_pos=msx.scatter_last(ms.lm_pos, gol, torch.where(used[:, None], X_f, X_local)),
    )
    ikf = ikf._replace(vel=put(ikf.vel, st_f.v), bg=put(ikf.bg, st_f.bg), ba=put(ikf.ba, st_f.ba))
    return ms, ikf, costs[-1]
