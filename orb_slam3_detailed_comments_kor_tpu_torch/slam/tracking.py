"""Tracking steps: project-match-optimize, keyframe insertion, and the
mapping steps the SLAM loop runs between frames.

Port of ``TrackResult``, ``_project_landmarks``, ``track_frame``,
``update_landmark_stats``, ``make_keyframe``, ``full_frame_step``,
``_finish_step``, ``full_mono_step``, ``full_rgbd_step``,
``full_fisheye_step``, ``local_ba_step``, ``add_triangulated_landmarks``,
``triangulate_with_neighbor``, ``cull_landmarks`` and
``cull_redundant_keyframes`` from
``orb_slam3_detailed_comments_kor_tpu/slam/tracking.py``.

``full_frame_step`` (stereo), ``full_mono_step`` (monocular, with the
IMU pose prior), ``full_rgbd_step`` (RGB-D) and ``full_fisheye_step``
(dual fisheye, with the prior and the right-camera rig rows) are the
per-frame paths: the front end, a three-stage project → match →
motion-only BA, landmark stats and the motion model.
Everything stays on the device with static shapes and ``torch.where``
selection; the caller's only host read is ``n_inliers``. The monocular
mapping steps (neighbour triangulation and landmark creation) read
nothing back either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching, twoview
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, factors
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as fe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.slam.frontend import Frame
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class TrackResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    lm_feat: torch.Tensor     # [L] matched feature idx per landmark (-1)
    lm_inlier: torch.Tensor   # [L] bool, survived pose optimization
    n_inliers: torch.Tensor   # scalar
    n_visible: torch.Tensor   # scalar (landmarks in frustum)


def _visibility(X, normal, min_d, max_d, valid, R_cw, t_cw, cam_params, w, h,
                scale, n_levels, cam_model):
    """Frustum + scale-band + viewing-angle test (Frame::isInFrustum)."""
    pc = X @ R_cw.T + t_cw
    uv = cam_mod.project(cam_params, pc, cam_model)
    Ow = -R_cw.T @ t_cw
    delta = X - Ow
    dist = torch.linalg.vector_norm(delta, dim=-1)
    viewcos = torch.sum(delta * normal, dim=-1) / torch.clamp(dist, min=1e-6)
    visible = (
        valid
        & (pc[:, 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        & (dist >= 0.8 * min_d)
        & (dist <= 1.3 * max_d)
        & (viewcos > 0.5)
    )
    return uv, msx.predict_level(dist, max_d, scale, n_levels), visible


def _project_landmarks(ms, R_cw, t_cw, cam_params, w, h, scale, n_levels,
                       cam_model="pinhole"):
    """Visibility of the whole landmark block."""
    return _visibility(
        ms.lm_pos, ms.lm_normal, ms.lm_min_dist, ms.lm_max_dist, ms.lm_valid,
        R_cw, t_cw, cam_params, w, h, scale, n_levels, cam_model,
    )


def track_frame(
    ms: msx.MapState,
    frame: Frame,
    R_pred: torch.Tensor,
    t_pred: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    w: int,
    h: int,
    scale: float = 1.2,
    n_levels: int = 8,
    r_wide: float = 15.0,
    r_narrow: float = 4.0,
    track_cap: int = 4096,
    prior=None,
    cam_model: str = "pinhole",
    rig=None,
    far_dist: float = 0.0,
) -> TrackResult:
    """Three-stage project → match → optimize.

    The visible landmarks are compacted into a static ``track_cap`` window
    first (the reference's local map points), so the matcher and the LM
    iterations run over [track_cap] rather than [L]. With a ``rig`` the
    pose solves add each matched feature's right-camera row (``frame.uv_r``).
    """
    L = ms.L
    V = track_cap
    dev = ms.lm_pos.device
    _, _, vis0 = _project_landmarks(
        ms, R_pred, t_pred, cam_params, w, h, scale, n_levels, cam_model
    )
    if far_dist > 0.0:
        # thFarPoints: drop landmarks beyond the configured depth
        pc0 = ms.lm_pos @ R_pred.T + t_pred
        vis0 = vis0 & (pc0[:, 2] <= far_dist)
    # --- compact visible landmarks into V slots (masked static shape) ----
    # invisible and overflowing landmarks all write to the parking slot V
    local = torch.where(vis0, torch.cumsum(vis0, 0) - 1, V)
    local = torch.clamp(local, max=V)
    lm_ids = torch.arange(L, dtype=torch.int32, device=dev)
    sel = msx.scatter_drop(torch.zeros((V,), dtype=torch.int32, device=dev), local, lm_ids)
    used = msx.scatter_drop(torch.zeros((V,), dtype=torch.bool, device=dev), local, vis0)
    sel_l = sel.to(torch.int64)
    X_v = ms.lm_pos[sel_l]
    desc_v = ms.lm_desc[sel_l]  # packed: the matcher kernel takes it as is
    normal_v = ms.lm_normal[sel_l]
    mind_v = ms.lm_min_dist[sel_l]
    maxd_v = ms.lm_max_dist[sel_l]
    # 1 / scale ** (2 level), in the form XLA compiles it to: scale ** (-2 level)
    inv_sigma2_feat = scale ** (-2.0 * frame.level.to(torch.float32))

    def stage(R, t, radius, max_dist, rounds, iters):
        uv, lvl, vis = _visibility(
            X_v, normal_v, mind_v, maxd_v, used, R, t, cam_params, w, h,
            scale, n_levels, cam_model,
        )
        res = matching.search_by_projection(
            uv, lvl, desc_v, vis,
            frame.xy, frame.level, frame.desc_packed, frame.valid,
            radius=radius, scale=scale, max_dist=max_dist,
        )
        res = matching.resolve_duplicate_targets(res, frame.n)
        feat = torch.clamp(res.idx, min=0).to(torch.int64)
        opt = ba.pose_optimization(
            R, t, X_v, frame.xy[feat], frame.u_right[feat],
            inv_sigma2_feat[feat], res.valid, cam_params, bf,
            rounds=rounds, iters=iters, prior=prior, cam_model=cam_model,
            uv_r=None if rig is None else frame.uv_r[feat], rig=rig,
        )
        return opt, res, vis

    # wide stage: full 4x10 budget; narrow: 2x8; ultra-narrow re-match at
    # the converged pose (2 px, strict descriptor gate), kept only when it
    # retains the consensus (see the reference for the measurements)
    opt1, _, _ = stage(R_pred, t_pred, r_wide, matching.TH_HIGH, 4, 10)
    opt2, res2, vis2 = stage(opt1.R_cw, opt1.t_cw, r_narrow, matching.TH_HIGH, 2, 8)
    opt3, res3, vis3 = stage(opt2.R_cw, opt2.t_cw, 2.0, 60, 1, 6)
    use3 = (res3.valid & opt3.inlier).sum() >= 0.6 * (res2.valid & opt2.inlier).sum()
    pick = lambda a, b: torch.where(use3, a, b)
    opt2 = ba.PoseOptResult(*map(pick, opt3, opt2))
    res2 = matching.MatchResult(*map(pick, res3, res2))
    vis2 = pick(vis3, vis2)
    inlier_v = res2.valid & opt2.inlier  # [V]
    # --- scatter results back to the [L] landmark block ------------------
    dst = torch.where(used, sel, L)  # unused slots park out of range
    lm_feat = msx.scatter_drop(
        torch.full((L,), -1, dtype=torch.int32, device=dev), dst,
        torch.where(inlier_v, res2.idx, -1),
    )
    lm_inlier = msx.scatter_drop(torch.zeros((L,), dtype=torch.bool, device=dev), dst, inlier_v)
    return TrackResult(
        R_cw=opt2.R_cw,
        t_cw=opt2.t_cw,
        lm_feat=lm_feat,
        lm_inlier=lm_inlier,
        n_inliers=torch.sum(inlier_v),
        n_visible=torch.sum(vis2),
    )


def full_frame_step(
    ms: msx.MapState,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    R_last: torch.Tensor,
    t_last: torch.Tensor,
    vel_R: torch.Tensor,
    vel_t: torch.Tensor,
    has_vel: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    w: int,
    h: int,
    scale: float = 1.2,
    n_levels: int = 8,
    n_features: int = 1200,
    cell: int = 32,
    min_inliers: int = 10,
    far_dist: float = 0.0,
):
    """The whole per-frame hot path: stereo ORB front-end + track +
    landmark stats + motion-model update.

    Returns (ms', frame, tr, R, t, vel_R, vel_t, ok); ``ok`` and the pose
    fallback are resolved on the device.
    """
    frame = fe.process_stereo(
        img_l, img_r, bf, n_features=n_features, n_levels=n_levels,
        scale=scale, cell=cell,
    )
    R_pred, t_pred = _motion_model(R_last, t_last, vel_R, vel_t, has_vel)
    tr = track_frame(
        ms, frame, R_pred, t_pred, cam_params, bf, w, h, scale, n_levels,
        far_dist=far_dist,
    )
    return _finish_step(ms, frame, tr, R_last, t_last, vel_R, vel_t, min_inliers)


def _motion_model(R_last, t_last, vel_R, vel_t, has_vel):
    """The per-frame steps' predicted pose: vel ∘ T_last when the velocity
    is known (resolved on the device), else T_last."""
    R_pred0, t_pred0 = lie.se3_compose(vel_R, vel_t, R_last, t_last)
    return torch.where(has_vel, R_pred0, R_last), torch.where(has_vel, t_pred0, t_last)


def _finish_step(ms, frame, tr, R_last, t_last, vel_R, vel_t, min_inliers):
    """The per-frame steps' shared epilogue: landmark stats, then the
    motion model vel = T_new ∘ inv(T_last) and the pose, both frozen when
    tracking failed (resolved on the device)."""
    ok = tr.n_inliers >= min_inliers
    ms = update_landmark_stats(ms, tr)
    Ri, ti = lie.se3_inverse(R_last, t_last)
    vR_new, vt_new = lie.se3_compose(tr.R_cw, tr.t_cw, Ri, ti)
    vel_R = torch.where(ok, vR_new, vel_R)
    vel_t = torch.where(ok, vt_new, vel_t)
    R_out = torch.where(ok, tr.R_cw, R_last)
    t_out = torch.where(ok, tr.t_cw, t_last)
    return ms, frame, tr, R_out, t_out, vel_R, vel_t, ok


def full_mono_step(
    ms: msx.MapState,
    img: torch.Tensor,
    R_last: torch.Tensor,
    t_last: torch.Tensor,
    vel_R: torch.Tensor,
    vel_t: torch.Tensor,
    has_vel: torch.Tensor,
    cam_params: torch.Tensor,
    prior,
    bf: float = 0.0,
    w: int = 752,
    h: int = 480,
    scale: float = 1.2,
    n_levels: int = 8,
    n_features: int = 1200,
    cell: int = 32,
    min_inliers: int = 10,
    cam_model: str = "pinhole",
    dist=None,
    far_dist: float = 0.0,
):
    """The monocular (and mono-inertial) per-frame path: mono ORB
    front-end, the three-stage track, stats and the motion model.
    ``prior`` is an always-present (R_p, t_p, info_R, info_t) tuple: zero
    informations disable the IMU-predicted pose pull (the fused analog of
    PoseInertialOptimizationLastKeyFrame, ``Optimizer.cc:6697``)."""
    frame = fe.process_mono(
        img, n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
        dist=dist, cam_params=cam_params,
    )
    R_pred, t_pred = _motion_model(R_last, t_last, vel_R, vel_t, has_vel)
    tr = track_frame(
        ms, frame, R_pred, t_pred, cam_params, bf, w, h, scale, n_levels,
        prior=prior, cam_model=cam_model, far_dist=far_dist,
    )
    return _finish_step(ms, frame, tr, R_last, t_last, vel_R, vel_t, min_inliers)


def full_rgbd_step(
    ms: msx.MapState,
    img: torch.Tensor,
    depth_map: torch.Tensor,
    R_last: torch.Tensor,
    t_last: torch.Tensor,
    vel_R: torch.Tensor,
    vel_t: torch.Tensor,
    has_vel: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    w: int,
    h: int,
    scale: float = 1.2,
    n_levels: int = 8,
    n_features: int = 1200,
    cell: int = 32,
    min_inliers: int = 10,
    dist=None,
    far_dist: float = 0.0,
):
    """The RGB-D per-frame path (the RGB-D Frame constructor,
    ``Frame.cc:201``, then the track): the stereo step's stages on a gray
    image and its depth map."""
    frame = fe.process_rgbd(
        img, depth_map, bf, n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
        dist=dist, cam_params=cam_params,
    )
    R_pred, t_pred = _motion_model(R_last, t_last, vel_R, vel_t, has_vel)
    tr = track_frame(
        ms, frame, R_pred, t_pred, cam_params, bf, w, h, scale, n_levels,
        far_dist=far_dist,
    )
    return _finish_step(ms, frame, tr, R_last, t_last, vel_R, vel_t, min_inliers)


def full_fisheye_step(
    ms: msx.MapState,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    R_last: torch.Tensor,
    t_last: torch.Tensor,
    vel_R: torch.Tensor,
    vel_t: torch.Tensor,
    has_vel: torch.Tensor,
    cam_params: torch.Tensor,
    cam_params_r: torch.Tensor,
    R_rl: torch.Tensor,
    t_rl: torch.Tensor,
    prior,
    w: int,
    h: int,
    scale: float = 1.2,
    n_levels: int = 8,
    n_features: int = 1200,
    cell: int = 32,
    min_inliers: int = 10,
    far_dist: float = 0.0,
):
    """The dual-fisheye (KannalaBrandt8 x2) per-frame path (the
    stereo-fisheye Frame constructor, ``Frame.cc:1021``, then the track):
    bf 0 (no rectified stereo row), the KB8 model, the right-camera rows
    through (R_rl, t_rl, cam_params_r), and the always-present pose
    ``prior`` of ``full_mono_step``."""
    frame = fe.process_stereo_fisheye(
        img_l, img_r, cam_params, cam_params_r, R_rl, t_rl,
        n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
    )
    R_pred, t_pred = _motion_model(R_last, t_last, vel_R, vel_t, has_vel)
    tr = track_frame(
        ms, frame, R_pred, t_pred, cam_params, 0.0, w, h, scale, n_levels,
        prior=prior, cam_model="kannala_brandt8", rig=(R_rl, t_rl, cam_params_r), far_dist=far_dist,
    )
    return _finish_step(ms, frame, tr, R_last, t_last, vel_R, vel_t, min_inliers)


def update_landmark_stats(
    ms: msx.MapState, tr: TrackResult, visible_mask=None
) -> msx.MapState:
    """found/visible counters (MapPoint::IncreaseFound/Visible)."""
    found = ms.lm_found + tr.lm_inlier.to(torch.int32)
    if visible_mask is None:
        visible_mask = tr.lm_inlier
    visible = ms.lm_visible + visible_mask.to(torch.int32)
    return ms._replace(lm_found=found, lm_visible=visible)


def make_keyframe(
    ms: msx.MapState,
    frame: Frame,
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    time,
    kf_idx: int,
    lm_feat: torch.Tensor,
    cam_params: torch.Tensor,
    depth_far: float,
    scale: float = 1.2,
    n_levels: int = 8,
    cam_model: str = "pinhole",
) -> msx.MapState:
    """Insert a keyframe + spawn stereo landmarks for unmatched close
    features. lm_feat [L] is the tracking association (feature idx or -1).

    The association is inverted as the reference inverts it
    (tracking.py:476-487): every unmatched landmark writes "no match" to
    feature 0, and the last write to a feature wins (``scatter_last``), so
    feature 0 keeps a match only when no unmatched landmark comes after
    the matched one, as on the reference's CPU.
    """
    N = frame.n
    L = ms.L
    dev = frame.xy.device
    # invert landmark→feature into feature→landmark
    tgt = torch.clamp(lm_feat, min=0)
    lm_ids = torch.arange(L, dtype=torch.int32, device=dev)
    feat_lm = msx.scatter_last(torch.full((N,), -1, dtype=torch.int32, device=dev), tgt,
                               torch.where(lm_feat >= 0, lm_ids, -1))
    matched = msx.scatter_last(torch.zeros((N,), dtype=torch.bool, device=dev), tgt, lm_feat >= 0)
    feat_lm = torch.where(matched, feat_lm, -1)

    # ---- new landmarks from stereo depth --------------------------------
    # close points always spawn; if fewer than 100 are close, spawn the 100
    # nearest anyway (CreateNewKeyFrame's sorted-nearest fallback)
    candidate = frame.valid & (frame.depth > 0.0) & (feat_lm < 0)
    depth_sorted = torch.sort(torch.where(candidate, frame.depth, float("inf"))).values
    depth_100 = depth_sorted[min(99, N - 1)]
    eff_far = torch.clamp(depth_100 * 1.0001, min=depth_far)
    want = candidate & (frame.depth < eff_far)
    slots = msx.allocate_slots(~ms.lm_valid, want)
    got = slots >= 0
    sl = torch.where(got, slots, L)  # non-allocations park at L

    rays = cam_mod.unproject(cam_params, frame.xy, cam_model)
    pc = rays * frame.depth[:, None]
    R_wc = R_cw.T
    Ow = -R_wc @ t_cw
    Xw = pc @ R_wc.T + Ow
    delta = Xw - Ow
    dist = torch.linalg.vector_norm(delta, dim=-1)
    normal = delta / torch.clamp(dist[:, None], min=1e-6)
    mind, maxd = msx.landmark_scale_band(dist, frame.level, scale, n_levels)

    put = lambda arr, vals: msx.scatter_drop(arr, sl, vals)
    ones = torch.ones((N,), dtype=torch.int32, device=dev)
    ms = ms._replace(
        lm_pos=put(ms.lm_pos, Xw),
        lm_valid=put(ms.lm_valid, True),
        lm_desc=put(ms.lm_desc, frame.desc_packed),
        lm_normal=put(ms.lm_normal, normal),
        lm_min_dist=put(ms.lm_min_dist, mind),
        lm_max_dist=put(ms.lm_max_dist, maxd),
        lm_found=put(ms.lm_found, ones),
        lm_visible=put(ms.lm_visible, ones),
        lm_first_kf=put(ms.lm_first_kf, torch.full((N,), kf_idx, dtype=torch.int32, device=dev)),
    )
    feat_lm = torch.where(got, slots, feat_lm)

    # ---- write the keyframe slot ----------------------------------------
    def row(arr, val):
        arr = arr.clone()
        if not isinstance(val, torch.Tensor):  # a host value would be copied over and waited for
            val = torch.full((), val, dtype=arr.dtype, device=dev)
        arr[kf_idx] = val
        return arr

    return ms._replace(
        kf_R_cw=row(ms.kf_R_cw, R_cw),
        kf_t_cw=row(ms.kf_t_cw, t_cw),
        kf_valid=row(ms.kf_valid, True),
        kf_time=row(ms.kf_time, time),
        kf_xy=row(ms.kf_xy, frame.xy),
        kf_level=row(ms.kf_level, frame.level),
        kf_angle=row(ms.kf_angle, frame.angle),
        kf_desc=row(ms.kf_desc, frame.desc_packed),
        kf_ur=row(ms.kf_ur, frame.u_right),
        kf_uvr=row(ms.kf_uvr, -1.0 if frame.uv_r is None else frame.uv_r),
        kf_feat_valid=row(ms.kf_feat_valid, frame.valid),
        obs_lm=row(ms.obs_lm, feat_lm),
    )


def _top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, the lower index first among equal
    values (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def local_ba_step(
    ms: msx.MapState,
    center_kf: int,
    cam_params: torch.Tensor,
    bf: float,
    window: int = 8,
    lm_cap: int = 4096,
    iters: int = 8,
    scale: float = 1.2,
    cam_model: str = "pinhole",
    rig=None,
) -> msx.MapState:
    """Covisibility-window local BA with landmark compaction.

    Picks the ``window`` most-covisible keyframes of ``center_kf`` (a
    Python int, plus itself), compacts their observed landmarks into a
    static ``lm_cap`` block, runs Schur-LM BA with the oldest window
    keyframe fixed, and scatters the refined poses/points back into the
    map. Nothing here reads the device.

    The refined points go back as the reference scatters them: every unused
    slot of the block writes landmark 0's old position to landmark 0 after
    the used slots, and the last write wins (``scatter_last``), so landmark
    0 keeps its position whenever the block has an unused slot.

    With a ``rig`` each observation adds its right-camera row
    (``kf_uvr``); a right row alone never drops an observation.
    """
    K, N, L = ms.K, ms.N, ms.L
    dev = ms.lm_pos.device
    center = torch.arange(center_kf, center_kf + 1, device=dev)
    cov = msx.covisibility_weights(ms, center)[0]  # [K]
    cov = torch.where(torch.arange(K, device=dev) == center_kf, 1 << 20, cov)  # center first
    cov = torch.where(ms.kf_valid, cov, -1)
    win = _top_k_stable(cov, window)  # [W] kf indices (desc covis)
    win_valid = cov[win] > 0

    # fix the oldest valid kf in the window (gauge anchor)
    win_times = torch.where(win_valid, ms.kf_time[win], float("inf"))
    anchor = torch.argmin(win_times)
    ww = torch.arange(window, device=dev)
    fixed_pose = (ww == anchor) | ~win_valid
    # single-KF maps: everything fixed -> no-op BA; guard by freeing slot 0
    n_free = torch.sum(~fixed_pose)
    fixed_pose = torch.where(n_free == 0, fixed_pose & (ww != 0), fixed_pose)

    # ---- landmark window compaction -------------------------------------
    obs_rows = ms.obs_lm[win]              # [W,N]
    feat_ok = ms.kf_feat_valid[win] & (obs_rows >= 0) & win_valid[:, None]
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

    # ---- flat observation table -----------------------------------------
    lm_local = local_of_global[torch.clamp(obs_rows, min=0).to(torch.int64)]  # [W,N]
    obs_valid = feat_ok & (lm_local < lm_cap)
    kf_col = ww[:, None].expand(window, N)
    inv_s2 = scale ** (-2.0 * ms.kf_level[win].to(torch.float32))  # as XLA compiles 1 / scale ** (2 level)
    obs = factors.Observations(
        kf=kf_col.reshape(-1),
        lm=torch.clamp(lm_local, 0, lm_cap - 1).reshape(-1),
        uv=ms.kf_xy[win].reshape(-1, 2),
        u_right=ms.kf_ur[win].reshape(-1),
        inv_sigma2=inv_s2.reshape(-1),
        valid=obs_valid.reshape(-1),
    )
    if rig is not None:
        # one right-camera mono row per matched feature (the ToBody edges)
        obs = factors.with_rig_rows(obs, ms.kf_uvr[win].reshape(-1, 2))
    res = ba.bundle_adjust(
        ms.kf_R_cw[win], ms.kf_t_cw[win], X_local, obs, fixed_pose, ~used,
        cam_params, bf, iters=iters, cam_model=cam_model, rig=rig,
    )

    # ---- scatter back ----------------------------------------------------
    upd_pose = win_valid & ~fixed_pose
    kf_R_cw, kf_t_cw, obs_lm = ms.kf_R_cw.clone(), ms.kf_t_cw.clone(), ms.obs_lm.clone()
    kf_R_cw[win] = torch.where(upd_pose[:, None, None], res.R_cw, ms.kf_R_cw[win])
    kf_t_cw[win] = torch.where(upd_pose[:, None], res.t_cw, ms.kf_t_cw[win])
    lm_pos = msx.scatter_last(ms.lm_pos, gol, torch.where(used[:, None], res.X, X_local))
    # Drop observations BA marked as clear outliers: only at 4x the chi2
    # gate (the fixed-iteration f32 LM may not have converged), and never
    # below a floor of 30 observations per keyframe (an obs-less keyframe
    # floats free and corrupts later windows).
    delta2 = torch.where(obs.u_right >= 0, 7.815, 5.991)
    # drop decisions are per left feature slot: the rig's right rows follow
    egregious2d = (obs.valid & (res.chi2 > 4.0 * delta2))[: window * N].view(window, N)
    would_keep = torch.sum(obs.valid[: window * N].view(window, N) & ~egregious2d, dim=1)
    allow_drop = (would_keep >= 30)[:, None]
    new_rows = torch.where(egregious2d & allow_drop, -1, obs_rows)
    obs_lm[win] = torch.where(win_valid[:, None], new_rows, obs_rows)
    return ms._replace(kf_R_cw=kf_R_cw, kf_t_cw=kf_t_cw, lm_pos=lm_pos, obs_lm=obs_lm)


def add_triangulated_landmarks(
    ms: msx.MapState,
    kf_a: int,
    kf_b,
    feat_b: torch.Tensor,
    X_w: torch.Tensor,
    want: torch.Tensor,
    cam_params: torch.Tensor,
    scale: float = 1.2,
    n_levels: int = 8,
) -> msx.MapState:
    """Landmarks from triangulated pairs between keyframe ``kf_a`` (a
    Python int) and its partners (LocalMapping::CreateNewMapPoints,
    ``LocalMapping.cc:492``; also the monocular initialization).

    Arrays are indexed by kf_a's feature slots: feat_b [N] the matching
    feature in the partner (-1 none), X_w [N,3] world positions, want [N]
    the gate. ``kf_b`` is one partner (an int: two-view initialization) or
    one per feature ([N] tensor: the multi-neighbour triangulation). The
    partners' observation rows are written as the reference's CPU scatter
    writes them (the last write to a slot wins, ``scatter_last``).
    """
    N, L, K = ms.N, ms.L, ms.K
    dev = X_w.device
    if not isinstance(kf_b, torch.Tensor):
        kf_b = torch.full((), kf_b, dtype=torch.int32, device=dev)
    kf_b = kf_b.expand(feat_b.shape)
    slots = msx.allocate_slots(~ms.lm_valid, want)
    got = slots >= 0
    sl = torch.where(got, slots, L)

    R_a, t_a = ms.kf_R_cw[kf_a], ms.kf_t_cw[kf_a]
    Ow = -R_a.T @ t_a
    delta = X_w - Ow
    dist = torch.linalg.vector_norm(delta, dim=-1)
    normal = delta / torch.clamp(dist[:, None], min=1e-6)
    mind, maxd = msx.landmark_scale_band(dist, ms.kf_level[kf_a], scale, n_levels)

    put = lambda arr, vals: msx.scatter_drop(arr, sl, vals)
    twos = torch.full((N,), 2, dtype=torch.int32, device=dev)
    ms = ms._replace(
        lm_pos=put(ms.lm_pos, X_w),
        lm_valid=put(ms.lm_valid, True),
        lm_desc=put(ms.lm_desc, ms.kf_desc[kf_a]),
        lm_normal=put(ms.lm_normal, normal),
        lm_min_dist=put(ms.lm_min_dist, mind),
        lm_max_dist=put(ms.lm_max_dist, maxd),
        lm_found=put(ms.lm_found, twos),
        lm_visible=put(ms.lm_visible, twos),
        lm_first_kf=put(ms.lm_first_kf, torch.full((N,), kf_a, dtype=torch.int32, device=dev)),
    )
    # observation rows: kf_a at its own feature slots, each feature's
    # partner at the matched slot (invalid pairs park past the table)
    obs_lm = ms.obs_lm.clone()
    obs_lm[kf_a] = torch.where(got, slots, ms.obs_lm[kf_a])
    ok_b = got & (feat_b >= 0) & (kf_b >= 0)
    flat = torch.where(ok_b, kf_b.to(torch.int64) * N + feat_b, K * N)
    obs_lm = msx.scatter_last(obs_lm.view(-1), flat, slots).view(K, N)
    return ms._replace(obs_lm=obs_lm)


def triangulate_with_neighbor(
    ms: msx.MapState,
    kf_idx: int,
    cam_params: torch.Tensor,
    w: int,
    h: int,
    scale: float = 1.2,
    n_levels: int = 8,
    max_reproj_px: float = 2.0,
    min_parallax_cos: float = 0.99998,
    cam_model: str = "pinhole",
    n_neighbors: int = 5,
    far_dist: float = 0.0,
):
    """Mapping-time triangulation of keyframe ``kf_idx``'s unmatched
    features against its ``n_neighbors`` most covisible keyframes
    (``LocalMapping::CreateNewMapPoints``, ``src/LocalMapping.cc:492-954``;
    ``SearchForTriangulation``, ``src/ORBmatcher.cc:965``): per neighbour a
    ratio-test match, midpoint triangulation and the depth, reprojection
    and parallax gates; each feature keeps the passing neighbour with the
    lowest cos-parallax (the strongest baseline).

    Returns (feat_b [N], X_w [N,3], want [N], nb_of_feat [N]): the
    matched feature, the world point, the gate and the chosen neighbour
    per feature (-1 where none passes).
    """
    N, K = ms.N, ms.K
    dev = ms.kf_xy.device
    kk = torch.arange(K, device=dev)
    cov = msx.covisibility_weights(ms, kk[kf_idx:kf_idx + 1])[0]
    cov = torch.where((kk == kf_idx) | ~ms.kf_valid, -1, cov)
    nbs = _top_k_stable(cov, n_neighbors)  # [Nb]
    nb_ok = cov[nbs] > 0

    da = orb_ops.unpack_descriptors(ms.kf_desc[kf_idx])
    va = ms.kf_feat_valid[kf_idx] & (ms.obs_lm[kf_idx] < 0)
    xy_a = ms.kf_xy[kf_idx]
    rays_a = cam_mod.unproject(cam_params, xy_a, cam_model)
    Rai, tai = lie.se3_inverse(ms.kf_R_cw[kf_idx], ms.kf_t_cw[kf_idx])
    sigma_a = scale ** ms.kf_level[kf_idx].to(torch.float32)

    # the neighbours' rows, gathered once; one ratio-test match each
    desc_b = ms.kf_desc[nbs]
    vb = ms.kf_feat_valid[nbs] & (ms.obs_lm[nbs] < 0) & nb_ok[:, None]
    xy_b = ms.kf_xy[nbs]
    matches = [matching.match_nn_ratio(da, orb_ops.unpack_descriptors(desc_b[i]), va, vb[i],
                                       max_dist=50, ratio=0.8) for i in range(n_neighbors)]
    idx = torch.stack([m.idx for m in matches])      # [Nb,N]
    mvalid = torch.stack([m.valid for m in matches])
    fb = torch.clamp(idx, min=0).to(torch.int64)
    xy_bf = torch.gather(xy_b, 1, fb[..., None].expand(-1, -1, 2))
    rays_b = cam_mod.unproject(cam_params, xy_bf, cam_model)
    R_ba, t_ba = lie.se3_compose(ms.kf_R_cw[nbs], ms.kf_t_cw[nbs], Rai, tai)
    X_a, dep_a, dep_b = twoview.triangulate_midpoint(R_ba, t_ba, rays_a, rays_b)
    uv_a = cam_mod.project(cam_params, X_a, cam_model)
    X_b = X_a @ R_ba.transpose(-1, -2) + t_ba[:, None, :]
    uv_b = cam_mod.project(cam_params, X_b, cam_model)
    err_a = torch.linalg.vector_norm(uv_a - xy_a, dim=-1)
    err_b = torch.linalg.vector_norm(uv_b - xy_bf, dim=-1)
    cospar = twoview._parallax_cos(R_ba, t_ba, X_a)
    good = (
        mvalid & nb_ok[:, None]
        & (dep_a > 0.05) & (dep_b > 0.05)
        & (err_a < max_reproj_px * sigma_a)
        & (err_b < max_reproj_px * sigma_a)
        & (cospar < min_parallax_cos)
    )
    if far_dist > 0.0:
        # thFarPoints triangulation gate (LocalMapping.cc:923)
        good = good & (dep_a < far_dist) & (dep_b < far_dist)
    feat_b_n = torch.where(mvalid, idx, -1)

    # per feature: the passing neighbour with the LOWEST cos-parallax
    pick = torch.argmin(torch.where(good, cospar, float("inf")), dim=0)[None]  # [1,N]
    want = torch.gather(good, 0, pick)[0]
    feat_b = torch.where(want, torch.gather(feat_b_n, 0, pick)[0], -1)
    X_a_sel = torch.gather(X_a, 0, pick[..., None].expand(1, N, 3))[0]
    nb_of_feat = torch.where(want, nbs[pick[0]].to(torch.int32), -1)
    X_w = X_a_sel @ Rai.T + tai
    return feat_b, X_w, want, nb_of_feat


def _observer_counts(obs_lm, ok, L):
    """Per landmark, the number of observations where ``ok``: [L] int32."""
    return torch.zeros((L,), dtype=torch.int32, device=obs_lm.device).index_add_(
        0, torch.clamp(obs_lm, min=0).reshape(-1).to(torch.int64),
        ok.reshape(-1).to(torch.int32),
    )


def cull_landmarks(ms: msx.MapState) -> msx.MapState:
    """Found-ratio culling (LocalMapping::MapPointCulling semantics) plus
    orphan collection: a landmark with no surviving keyframe observation
    can never be optimized or culled by the ratio test again, so it would
    hold its pool slot forever. Observation rows pointing at a culled
    landmark are cleared too, so that a recycled slot is never aliased."""
    ratio = ms.lm_found / torch.clamp(ms.lm_visible, min=1)
    bad = ms.lm_valid & (ms.lm_visible >= 4) & (ratio < 0.25)
    obs_ok = (ms.obs_lm >= 0) & ms.kf_feat_valid & ms.kf_valid[:, None]
    n_obs = _observer_counts(ms.obs_lm, obs_ok, ms.L)
    bad = bad | (ms.lm_valid & (n_obs == 0))
    stale = bad[torch.clamp(ms.obs_lm, min=0).to(torch.int64)] & (ms.obs_lm >= 0)
    return ms._replace(
        lm_valid=ms.lm_valid & ~bad,
        obs_lm=torch.where(stale, -1, ms.obs_lm),
    )


def cull_redundant_keyframes(
    ms: msx.MapState,
    protect: torch.Tensor,
    max_cull: int = 1,
    redundancy: float = 0.9,
) -> msx.MapState:
    """Redundant-keyframe culling (LocalMapping::KeyFrameCulling): a
    keyframe whose landmarks are more than ``redundancy`` observed by >= 3
    other keyframes is removed (marked invalid, observations cleared).

    protect [K] bool: keyframes that must never be culled. Up to
    ``max_cull`` keyframes are removed per call, the lowest slot first; the
    observer counts are recomputed after each removal.
    """
    K, L = ms.K, ms.L
    kk = torch.arange(K, device=ms.kf_valid.device)
    kf_valid, obs_lm = ms.kf_valid, ms.obs_lm
    for _ in range(max_cull):
        ok = (obs_lm >= 0) & ms.kf_feat_valid & kf_valid[:, None]
        n_obs = _observer_counts(obs_lm, ok, L)
        well_observed = n_obs[torch.clamp(obs_lm, min=0).to(torch.int64)] >= 4  # self + 3 others
        red = torch.sum(well_observed & ok, dim=1)
        tot = torch.clamp(torch.sum(ok, dim=1), min=1)
        redundant = kf_valid & ~protect & (red.to(torch.float32) / tot > redundancy)
        # argmax of the mask as int: the first redundant slot (or 0)
        cull = (kk == torch.argmax(redundant.to(torch.int32))) & torch.any(redundant)
        kf_valid = kf_valid & ~cull
        obs_lm = torch.where(cull[:, None], -1, obs_lm)
    return ms._replace(kf_valid=kf_valid, obs_lm=obs_lm)
