"""Atlas map merging: re-join a shelved map when place recognition finds
overlap with the active map.

Port of ``orb_slam3_detailed_comments_kor_tpu/slam/map_merging.py``
(``LoopClosing::MergeLocal``, visual): ``detect_merge_candidate``,
``verify_merge``, ``_concat_maps``, ``fuse_duplicate_landmarks``,
``merge_into_shelved``, ``try_merge`` and ``_merge_gate_allows``. The
active (younger) map is moved rigidly into the shelved map's frame, its
keyframe and landmark blocks are scattered into the shelved map's free
slots with an index remap, duplicate landmarks are fused, and an SE(3)
pose graph plus a welding-window BA spread the seam error; inertial maps
then weld their inertial chains (``MergeLocal2``).

Host reads: the candidate's BoW scores (one per shelf), the PnP and the
tracking-refinement inlier counts of a verification, one read of the gate's
poses, and one read of the concatenation's overflow, keyframe count and
keyframe remap; the reference reads the same values, some of them more
than once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching, ransac
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.optim import pose_graph
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as fe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


def detect_merge_candidate(bow_cur, shelved_db, n_kf_shelved: int,
                           min_score: float = 0.20) -> Tuple[int, float]:
    """Score the current keyframe's sparse BoW row against a shelved map's
    database (KeyFrameDatabase::DetectNBestCandidates, merge path).

    bow_cur: (ids [T], wts [T]); shelved_db: (ids [K,T], wts [K,T]).
    Returns (best keyframe index or -1, its score); one host read.
    """
    q_ids, q_wts = bow_cur
    db_ids, db_wts = shelved_db
    scores = voc.sparse_l1_score(q_ids, q_wts, db_ids[:n_kf_shelved], db_wts[:n_kf_shelved]).cpu().numpy()
    cand = int(scores.argmax())
    if scores[cand] < min_score:
        return -1, float(scores[cand])
    return cand, float(scores[cand])


def verify_merge(ms_cur: msx.MapState, kf_cur: int, ms_old: msx.MapState, kf_old: int, key,
                 min_inliers: int = 20, cam_params=None, bf: float = 0.0, w: int = 0, h: int = 0,
                 scale: float = 1.2, n_levels: int = 8):
    """Geometric verification across maps at reprojection accuracy: the
    current keyframe is relocalized inside the shelved map (descriptor
    matches give 2-D(cur)↔3-D(old) pairs, PnP RANSAC a pose, and a
    ``track_frame`` refinement against the whole shelved map the gate).

    Returns (ok, R, t) with X_old ≈ R·X_cur + t, from D = T_cw_old⁻¹ ∘
    T_cw_cur of the same camera. Two host reads (one if PnP fails).
    """
    da = orb_ops.unpack_descriptors(ms_cur.kf_desc[kf_cur])
    db = orb_ops.unpack_descriptors(ms_old.kf_desc[kf_old])
    va = ms_cur.kf_feat_valid[kf_cur]
    vb = ms_old.kf_feat_valid[kf_old] & (ms_old.obs_lm[kf_old] >= 0)
    res = matching.match_nn_ratio(da, db, va, vb, max_dist=60, ratio=0.85)
    feat_b = torch.clamp(res.idx, min=0).to(torch.int64)
    lm_b = ms_old.obs_lm[kf_old, feat_b]
    pair_ok = res.valid & (lm_b >= 0)
    X_old = ms_old.lm_pos[torch.clamp(lm_b, min=0).to(torch.int64)]
    uv_cur = ms_cur.kf_xy[kf_cur]
    R_pnp, t_pnp, _inl, n_pnp = ransac.pnp_ransac(X_old, uv_cur, pair_ok, cam_params, key,
                                                  n_hyp=192, inlier_px=6.0)
    if int(n_pnp) < 12:
        return False, R_pnp, t_pnp
    # tracking refinement against the whole shelved map (reloc-style gate)
    ur = ms_cur.kf_ur[kf_cur]
    disparity = torch.clamp(ms_cur.kf_xy[kf_cur, :, 0] - ur, min=1e-3)
    frame = fe.Frame(
        xy=uv_cur, level=ms_cur.kf_level[kf_cur], angle=ms_cur.kf_angle[kf_cur], desc=da,
        desc_packed=ms_cur.kf_desc[kf_cur], valid=va, u_right=ur,
        # a true division, as XLA compiles bf / x (torch's float / tensor
        # multiplies by the reciprocal)
        depth=torch.where(ur >= 0, disparity.new_full((), bf) / disparity, -1.0),
    )
    tr = tracking.track_frame(ms_old, frame, R_pnp, t_pnp, cam_params, bf, w=w, h=h, scale=scale,
                         n_levels=n_levels)
    ok = int(tr.n_inliers) >= max(30, min_inliers)
    # D = T_cw_old⁻¹ ∘ T_cw_cur
    Ro_i, to_i = lie.se3_inverse(tr.R_cw, tr.t_cw)
    R_d, t_d = lie.se3_compose(Ro_i, to_i, ms_cur.kf_R_cw[kf_cur], ms_cur.kf_t_cw[kf_cur])
    return ok, R_d, t_d


def _concat_maps(ms_old: msx.MapState, ms_cur: msx.MapState, n_kf_old: int, R_d, t_d):
    """Weld the active map (cur) into the shelved map's (old) arrays.

    cur poses and landmarks move by the world-to-world delta (X_old =
    R_d·X_cur + t_d; T_cw' = T_cw ∘ D⁻¹) and are scattered into old's free
    keyframe and landmark slots; keyframe and landmark indices inside the
    moved blocks are remapped. Returns (ms_merged, kf_remap [K] int32 (K
    for an invalid slot), n_kf_total and lm_overflow, 0-d tensors). Reads
    nothing from the device.
    """
    K, L = ms_old.K, ms_old.L
    dev = ms_old.lm_pos.device
    Rd_i, td_i = lie.se3_inverse(R_d, t_d)

    # keyframes: cur kf i -> slot n_kf_old + rank(i among valid); K parks
    cur_valid = ms_cur.kf_valid
    rank = torch.cumsum(cur_valid.to(torch.int32), 0) - 1
    kf_dst = torch.where(cur_valid, n_kf_old + rank, K).to(torch.int32)
    kf_at = torch.clamp(kf_dst, max=K)  # slots past the end are dropped too
    R_new = torch.einsum("kij,jl->kil", ms_cur.kf_R_cw, Rd_i)
    t_new = torch.einsum("kij,j->ki", ms_cur.kf_R_cw, td_i) + ms_cur.kf_t_cw

    # landmarks: free slots of old; overflow parks at L
    slots = msx.allocate_slots(~ms_old.lm_valid, ms_cur.lm_valid)
    got = slots >= 0
    sl = torch.where(got, slots, L)
    lm_overflow = torch.sum(ms_cur.lm_valid & ~got)
    X_new = ms_cur.lm_pos @ R_d.T + t_d
    nrm_new = ms_cur.lm_normal @ R_d.T
    first = ms_cur.lm_first_kf
    first_new = torch.where(first >= 0, kf_dst[torch.clamp(first, min=0).to(torch.int64)], -1)

    def lm(arr, vals):
        return msx.scatter_drop(arr, sl, vals)

    ms = ms_old._replace(
        lm_pos=lm(ms_old.lm_pos, X_new),
        lm_valid=lm(ms_old.lm_valid, ms_cur.lm_valid),
        lm_desc=lm(ms_old.lm_desc, ms_cur.lm_desc),
        lm_normal=lm(ms_old.lm_normal, nrm_new),
        lm_min_dist=lm(ms_old.lm_min_dist, ms_cur.lm_min_dist),
        lm_max_dist=lm(ms_old.lm_max_dist, ms_cur.lm_max_dist),
        lm_found=lm(ms_old.lm_found, ms_cur.lm_found),
        lm_visible=lm(ms_old.lm_visible, ms_cur.lm_visible),
        lm_first_kf=lm(ms_old.lm_first_kf, first_new.to(torch.int32)),
    )

    # observation rows: landmark ids remapped, then the rows scattered
    lm_remap = torch.where(got, slots, -1)  # [L] cur landmark -> merged id
    obs_new = torch.where(ms_cur.obs_lm >= 0,
                          lm_remap[torch.clamp(ms_cur.obs_lm, min=0).to(torch.int64)], -1)

    def kf(arr, vals):
        return msx.scatter_drop(arr, kf_at, vals)

    ms = ms._replace(
        kf_R_cw=kf(ms.kf_R_cw, R_new),
        kf_t_cw=kf(ms.kf_t_cw, t_new),
        kf_valid=kf(ms.kf_valid, cur_valid),
        kf_time=kf(ms.kf_time, ms_cur.kf_time),
        kf_xy=kf(ms.kf_xy, ms_cur.kf_xy),
        kf_level=kf(ms.kf_level, ms_cur.kf_level),
        kf_angle=kf(ms.kf_angle, ms_cur.kf_angle),
        kf_desc=kf(ms.kf_desc, ms_cur.kf_desc),
        kf_ur=kf(ms.kf_ur, ms_cur.kf_ur),
        kf_uvr=kf(ms.kf_uvr, ms_cur.kf_uvr),
        kf_feat_valid=kf(ms.kf_feat_valid, ms_cur.kf_feat_valid),
        obs_lm=kf(ms.obs_lm, obs_new),
    )
    n_total = n_kf_old + torch.sum(cur_valid)
    return ms, kf_dst, n_total, lm_overflow


def _nearest_old(pos, old_mask):
    """Per landmark slot, the nearest original landmark and its squared
    distance, over every slot pair in 1024-row blocks (a fixed shape: no
    host read)."""
    L = pos.shape[0]
    axes = pos.T.contiguous()  # [3, L]: one contiguous row per coordinate
    chunk = min(1024, L)
    nearest, near_d2 = [], []
    for c0 in range(0, L, chunk):
        d2 = None
        for a in axes:  # (dx² + dy²) + dz², the reference's order
            d = a[c0:c0 + chunk, None] - a[None, :]
            d2 = d * d if d2 is None else d2 + d * d
        d2 = torch.where(old_mask[None, :], d2, float("inf"))
        nb = torch.argmin(d2, dim=1)
        nearest.append(nb)
        near_d2.append(torch.gather(d2, 1, nb[:, None])[:, 0])
    return torch.cat(nearest), torch.cat(near_d2)


def _nearest_old_compact(pos, old_mask, new_mask):
    """``_nearest_old`` for the rows of new landmarks only, over the
    columns of original ones (the CPU's path: it reads the masks, which
    costs nothing there). A new row's nearest original landmark and
    distance are bit-equal to ``_nearest_old``'s: the same squares summed
    in the same order, and the first minimum among the original columns in
    slot order; other rows get slot 0 at an infinite distance, which no
    caller reads (they are never fused)."""
    L = pos.shape[0]
    nearest = torch.zeros((L,), dtype=torch.int64)
    near_d2 = torch.full((L,), float("inf"), dtype=pos.dtype)
    rows, cols = torch.nonzero(new_mask)[:, 0], torch.nonzero(old_mask)[:, 0]
    if len(rows) == 0 or len(cols) == 0:
        return nearest, near_d2
    pr, pc = pos[rows].T.contiguous(), pos[cols].T.contiguous()
    for c0 in range(0, len(rows), 1024):
        d2 = None
        for a, b in zip(pr, pc):  # (dx² + dy²) + dz², the reference's order
            d = a[c0:c0 + 1024, None] - b[None, :]
            d2 = d * d if d2 is None else d2 + d * d
        nb = torch.argmin(d2, dim=1)
        nearest[rows[c0:c0 + 1024]] = cols[nb]
        near_d2[rows[c0:c0 + 1024]] = torch.gather(d2, 1, nb[:, None])[:, 0]
    return nearest, near_d2


def fuse_duplicate_landmarks(
    ms: msx.MapState,
    src_is_new: torch.Tensor,
    radius: float = 0.05,
    max_hamming: int = 50,
):
    """SearchAndFuse analog in 3-D: a new landmark (``src_is_new`` [L])
    within ``radius`` of an original landmark with a matching descriptor is
    replaced by it (observations rewritten, counters accumulated).

    Returns (ms', number fused as a 0-d tensor). The nearest original
    landmark comes from squared distances summed per component in 1024-row
    blocks, as the reference computes them (an expanded |a|^2 + |b|^2 - 2ab
    product rounds differently and would move near-tie argmins); argmin
    takes the first minimum, as jnp.argmin.
    """
    L = ms.L
    old_mask = ms.lm_valid & ~src_is_new
    new_mask = ms.lm_valid & src_is_new
    pos = ms.lm_pos
    if pos.device.type == "cpu":
        nearest, near_d2 = _nearest_old_compact(pos, old_mask, new_mask)
    else:
        nearest, near_d2 = _nearest_old(pos, old_mask)
    # the reference squares its traced f32 radius in f32
    r2 = float(np.float32(radius) * np.float32(radius))
    near_ok = near_d2 < r2
    ham = torch.sum(
        orb_ops.unpack_descriptors(ms.lm_desc) != orb_ops.unpack_descriptors(ms.lm_desc[nearest]),
        dim=-1,
    )
    fuse = new_mask & near_ok & (ham <= max_hamming)
    # rewrite observations: fused new id -> old id (MapPoint::Replace)
    remap = torch.where(fuse, nearest, torch.arange(L, device=pos.device)).to(torch.int32)
    obs = torch.where(ms.obs_lm >= 0, remap[torch.clamp(ms.obs_lm, min=0).to(torch.int64)], -1)
    # found/visible counters accumulate onto the kept landmark
    lm_found = ms.lm_found.index_add(0, nearest, torch.where(fuse, ms.lm_found, 0))
    lm_visible = ms.lm_visible.index_add(0, nearest, torch.where(fuse, ms.lm_visible, 0))
    return ms._replace(
        lm_valid=ms.lm_valid & ~fuse,
        obs_lm=obs,
        lm_found=lm_found,
        lm_visible=lm_visible,
    ), torch.sum(fuse)


def merge_into_shelved(slam, shelf_idx: int, kf_cur: int, kf_old: int, R_d, t_d) -> bool:
    """Weld the active map into ``slam.atlas_maps[shelf_idx]`` and make the
    result the active map (MergeLocal's main body). Returns False, with
    nothing changed, when the capacities cannot hold both maps."""
    shelf = slam.atlas_maps[shelf_idx]
    ms_old, n_old = shelf["ms"], shelf["n_kf"]
    n_cur = slam.n_kf
    if n_old + n_cur > slam.ms.K:
        return False
    ms, kf_dst, n_total, lm_overflow = _concat_maps(ms_old, slam.ms, n_old, R_d, t_d)
    # one host read: the overflow, the keyframe count and the remap
    host = torch.cat([lm_overflow.reshape(1).to(torch.int64), n_total.reshape(1).to(torch.int64),
                      kf_dst.to(torch.int64)]).cpu().numpy()
    if int(host[0]) > 0:
        return False
    n_total = int(host[1])
    dst = host[2:]
    dev = ms.lm_pos.device

    # duplicate fusion in the weld region; the flag scatter writes False for
    # every unallocated landmark at slot 0, in the reference's CPU order
    src_slots = msx.allocate_slots(~ms_old.lm_valid, slam.ms.lm_valid)
    src_is_new = msx.scatter_last(torch.zeros((ms.L,), dtype=torch.bool, device=dev),
                                  torch.clamp(src_slots, min=0), src_slots >= 0)
    ms, _n_fused = fuse_duplicate_landmarks(ms, src_is_new)

    # pose-graph weld: the temporal chains of both maps + the merge edge
    kf_cur_new = int(dst[kf_cur])
    i_seq = torch.arange(n_total - 1, device=dev)
    j_seq = torch.arange(1, n_total, device=dev)
    edges = pose_graph.make_edges_from_poses(i_seq, j_seq, ms.kf_R_cw, ms.kf_t_cw)
    # the chain crosses the map boundary at n_old: drop that edge
    edges = edges._replace(valid=edges.valid & (i_seq != n_old - 1))
    Rj_i, tj_i = lie.se3_inverse(ms.kf_R_cw[kf_old], ms.kf_t_cw[kf_old])
    Rw, tw = lie.se3_compose(ms.kf_R_cw[kf_cur_new], ms.kf_t_cw[kf_cur_new], Rj_i, tj_i)
    one = dict(device=dev)
    e_weld = pose_graph.PoseGraphEdges(
        i=torch.full((1,), kf_cur_new, dtype=torch.int64, **one),
        j=torch.full((1,), kf_old, dtype=torch.int64, **one),
        R_meas=Rw[None], t_meas=tw[None], s_meas=torch.ones((1,), **one),
        weight=torch.full((1,), 30.0, **one), valid=torch.ones((1,), dtype=torch.bool, **one),
    )
    edges = pose_graph.PoseGraphEdges(*(torch.cat(parts) for parts in zip(edges, e_weld)))
    kk = torch.arange(n_total, device=dev)
    fixed = (kk == 0) | (kk == kf_old)
    R_pg, t_pg = pose_graph.optimize_pose_graph_se3(ms.kf_R_cw[:n_total], ms.kf_t_cw[:n_total], edges,
                                                    fixed, iters=10)
    ms = ms._replace(kf_R_cw=torch.cat([R_pg, ms.kf_R_cw[n_total:]]),
                     kf_t_cw=torch.cat([t_pg, ms.kf_t_cw[n_total:]]))

    # welding-window BA (MergeBundleAdjustmentVisual, Optimizer.cc:5296):
    # a covisibility window around the welding keyframe takes both sides,
    # which the fusion made covisible; the rest of both maps stays put
    ms = tracking.local_ba_step(
        ms, kf_cur_new, slam.cam_params, slam.cfg.camera.bf, window=12,
        lm_cap=slam.cfg.capacity.max_local_landmarks, iters=4, cam_model=slam.cam_model, rig=slam.rig,
    )

    # install as the active map; the live pose moves with its map:
    # T_cw' = T_cw ∘ D⁻¹
    Rd_i, td_i = lie.se3_inverse(R_d, t_d)
    slam.R_cw, slam.t_cw = lie.se3_compose(slam.R_cw, slam.t_cw, Rd_i, td_i)
    slam.has_velocity = False
    slam.ms = ms
    slam.n_kf = n_total

    # merged BoW database: old rows stay, cur rows land at their new slots
    lc_old = shelf.get("loop_closer")
    if lc_old is not None and lc_old.db_words is not None and slam.loop_closer.db_words is not None:
        at = torch.clamp(kf_dst[:n_cur], max=ms.K).to(torch.int64)
        lc_old.db_words = msx.scatter_drop(lc_old.db_words, at, slam.loop_closer.db_words[:n_cur])
        lc_old.db_wts = msx.scatter_drop(lc_old.db_wts, at, slam.loop_closer.db_wts[:n_cur])
        slam.loop_closer = lc_old

    if slam.cfg.is_inertial and "ikf" in shelf:
        _weld_inertial(slam, shelf, kf_dst, R_d)

    # re-anchor the trajectory records: relative records survive the rigid
    # move (T_f T_kf⁻¹ is D-invariant); the young map's keyframe indices
    # moved to their new slots and the old map's records join the active
    # generation
    old_gen, cur_gen = shelf["gen"], slam._map_gen
    rewritten = []
    for (t, g, kf, R_rel, t_rel, R_abs, t_abs) in slam.trajectory:
        if g == old_gen:
            rewritten.append((t, cur_gen, kf, R_rel, t_rel, R_abs, t_abs))
        elif g == cur_gen and kf >= 0:
            R2, t2 = lie.se3_compose(R_abs, t_abs, Rd_i, td_i)
            rewritten.append((t, cur_gen, int(dst[kf]), R_rel, t_rel, R2, t2))
        else:
            rewritten.append((t, g, kf, R_rel, t_rel, R_abs, t_abs))
    slam.trajectory = rewritten
    del slam.atlas_maps[shelf_idx]
    return True


def _weld_inertial(slam, shelf, kf_dst, R_d) -> None:
    """The inertial state weld (MergeLocal2, ``LoopClosing.cc:1837``): the
    old map is the base and its gravity frame wins; the young map's
    velocities are world vectors and turn with the map delta (v' = R_d v);
    its windows, biases and validity land at its keyframes' new slots
    (slots past the capacity are dropped). Then, once the IMU is
    initialized, a bounded whole-map VI BA (MergeInertialBA,
    ``Optimizer.cc:6029``) restores IMU consistency across the seam."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial

    ikf_old, ikf_cur = shelf["ikf"], slam.ikf
    at = torch.clamp(kf_dst, max=ikf_old.vel.shape[0]).to(torch.int64)
    cur = ikf_cur._replace(vel=ikf_cur.vel @ R_d.T)
    slam.ikf = inertial.InertialKF(*(msx.scatter_drop(o, at, c) for o, c in zip(ikf_old, cur)))
    if shelf.get("imu_initialized", False):
        slam.gravity = shelf["gravity"]
    slam.imu_initialized = shelf.get("imu_initialized", False) or slam.imu_initialized
    if slam.imu_initialized:
        slam.ms, slam.ikf, _ = inertial.full_inertial_ba(
            slam.ms, slam.ikf, slam.gravity, slam.cam_params, slam.R_cb, slam.t_cb,
            slam.cfg.camera.bf, iters=2, cam_model=slam.cam_model, rig=slam.rig,
        )


def try_merge(slam) -> bool:
    """Run after keyframe insertion while shelved maps exist: detect,
    verify and execute a map merge (the LoopClosing merge path)."""
    if not slam.atlas_maps or slam.n_kf < 3:
        return False
    lc = slam.loop_closer
    if lc.vocab is None or lc.db_words is None:
        return False
    kf_cur = slam.n_kf - 1
    bow_cur = (lc.db_words[kf_cur], lc.db_wts[kf_cur])
    for shelf_idx, shelf in enumerate(slam.atlas_maps):
        lc_old = shelf.get("loop_closer")
        if lc_old is None or lc_old.db_words is None:
            continue
        cand, _score = detect_merge_candidate(bow_cur, (lc_old.db_words, lc_old.db_wts), shelf["n_kf"])
        if cand < 0:
            continue
        cam = slam.cfg.camera
        ok, R_d, t_d = verify_merge(
            slam.ms, kf_cur, shelf["ms"], cand, slam._split_key(), cam_params=slam.cam_params,
            bf=cam.bf, w=cam.width, h=cam.height, scale=slam.cfg.orb.scale_factor,
            n_levels=slam.cfg.orb.n_levels,
        )
        if not ok:
            continue
        if not _merge_gate_allows(slam, shelf, R_d, t_d):
            slam.stats["merges_rejected_gate"] = slam.stats.get("merges_rejected_gate", 0) + 1
            continue
        if merge_into_shelved(slam, shelf_idx, kf_cur, cand, R_d, t_d):
            return True
    return False


def _merge_gate_allows(slam, shelf, R_d, t_d) -> bool:
    """Merge-plausibility gate (the cross-map analog of the loop drift
    gate): the new map was born at the old map's last tracked pose, so the
    merge transform D (X_old = R_d X + t_d) must stay within drift of
    D_expected = T_cw_loss⁻¹ and rotate at most 25° away from it. The
    budget: metres for the blackout, a quarter of the new map's keyframe
    arc, a metre per second of the gap, half a metre per second of blind
    coasting. A missing prior (old shelves, relocalization shelves) or a
    monocular map skips the gate. One host read (the live pose, the
    transform and the new map's keyframe poses), in float32 as the
    reference reads them."""
    prior = shelf.get("merge_prior")
    if prior is None or slam.cfg.sensor == SensorType.MONOCULAR:
        return True
    R_loss, t_loss = prior[0], prior[1]
    n = slam.n_kf
    ms = slam.ms
    host = torch.cat([
        slam.R_cw.reshape(-1), slam.t_cw.reshape(-1), R_d.reshape(-1), t_d.reshape(-1),
        ms.kf_R_cw[:n].reshape(-1), ms.kf_t_cw[:n].reshape(-1),
    ]).cpu().numpy()
    R, t = host[:9].reshape(3, 3), host[9:12]
    R_dh, t_dh = host[12:21].reshape(3, 3), host[21:24]
    Rk, tk = host[24:24 + 9 * n].reshape(n, 3, 3), host[24 + 9 * n:].reshape(n, 3)
    c = -R.T @ t  # camera_center()
    d_hyp = R_dh @ c + t_dh
    d_exp = R_loss.T @ (c - t_loss)
    disp = float(np.linalg.norm(d_hyp - d_exp))
    # a wrong transform can match the current centre and still rotate the
    # rest of the map away; odometry yaw drift over a split is degrees
    R_err = R_dh @ R_loss  # hyp ∘ expected⁻¹ (R_exp = R_loss.T)
    ang = float(np.degrees(np.arccos(np.clip((np.trace(R_err) - 1.0) / 2.0, -1.0, 1.0))))
    if ang > 25.0:
        return False
    # arc travelled in the NEW map since the split (keyframe centres)
    centers = -np.einsum("kji,kj->ki", Rk, tk)
    arc = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
    t_split = prior[2] if len(prior) > 2 else 0.0
    coast_s = prior[3] if len(prior) > 3 else 0.0
    kt = slam._host_kf_times()
    gap_s = max(float(kt[0]) - t_split, 0.0) if len(kt) else 0.0
    budget = (
        2.0 + 10.0 * max(slam.baseline, 0.01)
        + 0.25 * arc
        + 1.0 * min(gap_s, 10.0)
        + 0.5 * min(coast_s, 10.0)
    )
    return disp <= budget
