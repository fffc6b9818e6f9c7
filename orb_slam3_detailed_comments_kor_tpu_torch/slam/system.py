"""Host-side SLAM system facade + tracking state machine, stereo path.

Port of the stereo pinhole path of
``orb_slam3_detailed_comments_kor_tpu/slam/system.py``:
``TrackingState``, ``select_eviction_slots``, ``reloc_candidate_groups``
and the parts of ``SlamSystem`` that ``track_stereo`` reaches -- stereo
initialization, the deferred, batched keyframe decisions, keyframe
insertion, the background FIFO of mapping slices (BoW inserts, duplicate
fusion, local BA, landmark and redundant keyframe culling, loop detection
and correction), the global-BA slices after a loop closure, capacity
reclaim, the lost path with relocalization (in the active map and in
shelved maps) and the trajectory. Loop closing is on by default, as in the
reference.

Counterpart of the reference's ``System`` (``src/System.cc``) and the host
control of ``Tracking::Track()`` (``src/Tracking.cc:1718-2234``). All
per-frame compute is ``tracking.full_frame_step`` on the device; the host
reads the device at initialization (the stereo depth count), in the
batched decision read, in ``_reclaim_kf_slots``, on the lost path, and in
a loop slice where the reference does (a verification's or hypothesis
step's inlier count, the drift gate's pose segment, the closure's log
line, a GBA slice's cost). Background mapping work runs as bounded
slices, one ahead of each frame's dispatch (``_service_background``), so a
frame never waits behind a whole solve.

Not in this slice: the Atlas merge (raises where the reference would
schedule it), localization mode, the inertial, monocular, RGB-D and
stereo-fisheye paths and map checkpoints.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.config import SLAMConfig, SensorType
from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching, ransac
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking
from orb_slam3_detailed_comments_kor_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie, prng
from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead as _HostRead
from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


def select_eviction_slots(cov, protect, n_kf: int, n_evict: int = 5,
                          protect_soft=None):
    """Covisibility-aware last-resort eviction (host-side, [K] arrays).

    Scores each unprotected slot by how strongly its temporal neighbours
    see each other: a slot inside a dense covisible cluster loses the least
    map coverage when removed, while sparse early "anchor" keyframes score
    low and survive. Greedy pick; a chosen slot disqualifies its immediate
    neighbours so no region is hollowed out. Returns evict mask [K] bool.

    ``protect`` is hard (never evicted); ``protect_soft`` (the live
    tracking window) is waived when honouring it would leave nothing to
    evict, because capacity pressure must always free at least one slot.
    """
    K = cov.shape[0]

    def greedy(mask):
        score = np.full((K,), -1.0)
        for i in range(1, n_kf - 1):
            if not mask[i]:
                score[i] = float(cov[i - 1, i + 1])
        picked = np.zeros((K,), bool)
        floor = 0.0
        for _ in range(n_evict):
            j = int(score.argmax())
            if score[j] < floor:  # only real (unprotected) scores pass
                break
            picked[j] = True
            # later picks must be in the densest pick's league: filling the
            # quota from sparse regions would drain the anchors
            floor = max(floor, 0.1 * score[j])
            score[max(j - 1, 0)] = -1.0
            score[j] = -1.0
            score[min(j + 1, K - 1)] = -1.0
        return picked

    hard = np.asarray(protect, bool)
    soft = hard if protect_soft is None else (hard | np.asarray(protect_soft, bool))
    evict = greedy(soft)
    if not evict.any():
        evict = greedy(hard)
    if not evict.any():  # everything hard-protected: oldest non-anchor
        for i in range(1, n_kf):
            if not hard[i]:
                evict[i] = True
                break
    return evict


def reloc_candidate_groups(
    cov, scores, top_k: int = 3, covis_min: float = 15.0,
    floor_ratio: float = 0.75, abs_floor: float = 0.05,
):
    """Covisibility-group relocalization candidates, best group first
    (``DetectRelocalizationCandidates``, ``src/KeyFrameDatabase.cc:733``):
    each keyframe's BoW score is accumulated over its covisibility group,
    groups below ``floor_ratio`` x the best are dropped, and each retained
    group contributes its best-scoring member. cov [n,n], scores [n]
    (numpy). Returns an ordered list of keyframe indices (<= top_k)."""
    cov = np.asarray(cov)
    s = np.maximum(np.asarray(scores), 0.0)
    n = s.shape[0]
    member = cov >= covis_min
    np.fill_diagonal(member, True)
    group_score = member @ s
    order = np.argsort(-group_score)
    floor = floor_ratio * float(group_score[order[0]])
    picked, seen = [], np.zeros((n,), bool)
    for i in order:
        if len(picked) >= top_k:
            break
        if seen[i] or group_score[i] < floor or s[i] <= 0.0:
            continue
        members = np.where(member[i])[0]
        best = int(members[np.argmax(s[members])])
        seen[members] = True
        seen[i] = True
        if s[best] < abs_floor or best in picked:
            continue
        picked.append(best)
    return picked


class SlamSystem:
    """Stereo SLAM system over device-resident map state.

    ``device`` is where the map, the vocabulary and every per-frame tensor
    live: the card unless the caller names another. ``enable_loop_closing``
    is True by default, as in the reference.
    """

    #: frames whose decision scalars are fetched with one batched readback
    #: (default; overridden from ``TrackingConfig.decision_batch``)
    decision_batch = 4

    def __init__(self, config: SLAMConfig, device="cuda"):
        cam = config.camera
        if (config.is_inertial or config.sensor != SensorType.STEREO
                or cam.model != "pinhole" or cam.right_intrinsics is not None):
            raise NotImplementedError(
                "only the stereo pinhole path is ported (no inertial, mono, "
                "RGB-D or stereo-fisheye configurations)"
            )
        self.cfg = config
        self.device = torch.device(device)
        cap = config.capacity
        self.n_feat = sum(
            orb_ops.level_budgets(
                config.orb.n_features, config.orb.n_levels, config.orb.scale_factor
            )
        )
        self.ms = msx.empty_map(cap.max_keyframes, self.n_feat, cap.max_landmarks,
                                device=self.device)
        self.cam_params = cam_mod.camera_params_from_config(cam, device=self.device)
        self.cam_model = cam.model
        self.state = TrackingState.NOT_INITIALIZED
        self.R_cw = torch.eye(3, device=self.device)
        self.t_cw = torch.zeros(3, device=self.device)
        self.vel_R = torch.eye(3, device=self.device)
        self.vel_t = torch.zeros(3, device=self.device)
        self.has_velocity = False
        # has_velocity as the step's device bool, made once: a tensor from a
        # host value per frame would make the stream wait on the host
        self._vel_flag = {
            v: torch.full((), v, dtype=torch.bool, device=self.device) for v in (False, True)
        }
        self.n_kf = 0
        self.frames_since_kf = 0
        self.inliers_at_last_kf = 0
        self.n_frames = 0
        self.n_lost_frames = 0
        self.stats = {
            "kf_inserted": 0, "kf_culled": 0, "kf_evicted": 0, "reclaims": 0,
        }
        # monotone index of dispatched tracked frames; each queued decision
        # snapshots it so the KF gap is computed against the DECIDED frame
        self._dispatch_idx = 0
        self._last_kf_dispatch_idx = 0
        self.decision_batch = config.tracking.decision_batch
        self._pending_decisions: List[tuple] = []
        self._inflight_decisions = None
        # Trajectory log: frame poses relative to their reference keyframe,
        # composed with the keyframe's FINAL pose at read time (the
        # reference's SaveTrajectoryEuRoC scheme, ``System.cc:503``). Entry:
        #   (time, map_gen, kf_ref, R_rel, t_rel, R_abs, t_abs)
        self.trajectory: List[tuple] = []
        self._map_gen = 0
        self._gen_counter = 0
        self._kf_times_host: List[float] = []
        self._kf_lowq_host: List[bool] = []
        self._cur_track_inliers = None
        self._last_track_time = None
        # FIFO of deferred per-keyframe mapping slices (see _bg_push)
        self._bg_queue: List[tuple] = []
        # Atlas: shelved maps (relocalization can switch back to one; the
        # Atlas merge is not ported)
        self.atlas_maps: List[dict] = []
        self.timer = StageTimer(enabled=False)
        # loop closing: the BoW database over the default vocabulary, and
        # the RANSAC draws' key, split where the reference splits it
        self.loop_closer = self._new_loop_closer()
        self.enable_loop_closing = True
        self._loop_key = prng.key_from_bytes(b"loopseed", self.device)
        # remaining bounded GBA slices after a loop correction
        self._gba_chunks_left = 0
        self._gba_chunks_run = 0
        self._gba_prev_cost = None

    def _new_loop_closer(self) -> LoopCloser:
        cap = self.cfg.capacity
        return LoopCloser(
            max_kf=cap.max_keyframes, vocab_k=cap.vocab_branching,
            vocab_depth=min(cap.vocab_depth, 3), vocab=voc.load_default(self.device),
        )

    def _split_key(self):
        """A fresh RANSAC key (``jax.random.split`` of the system's key)."""
        keys = prng.split(self._loop_key)
        self._loop_key = keys[0]
        return keys[1]

    @property
    def baseline(self) -> float:
        return self.cfg.camera.bf / self.cfg.camera.fx

    def _check_timestamp_jump(self, t: float) -> None:
        """Sensor-dropout guard (``Tracking.cc:1737-1773``): a timestamp
        gap > 3 s (or going backwards) shelves/resets the active map."""
        last = self._last_track_time
        self._last_track_time = t
        if last is None or self.state == TrackingState.NOT_INITIALIZED:
            return
        if t < last or t - last > 3.0:
            self.flush_decisions()
            if self.n_kf >= 5:
                self._create_map_in_atlas()
            else:
                self._reset_active_map()

    # ------------------------------------------------------------------
    def track_stereo(self, img_l, img_r, t: float) -> int:
        """Feed one rectified pinhole stereo pair (arrays or tensors of
        [H, W] intensities). Returns the tracking state."""
        cam = self.cfg.camera
        self.n_frames += 1
        self._check_timestamp_jump(t)
        img_l = torch.as_tensor(img_l, dtype=torch.float32, device=self.device)
        img_r = torch.as_tensor(img_r, dtype=torch.float32, device=self.device)
        if self.state == TrackingState.NOT_INITIALIZED:
            frame = frontend.process_stereo(
                img_l, img_r, cam.bf,
                n_features=self.cfg.orb.n_features,
                n_levels=self.cfg.orb.n_levels,
                scale=self.cfg.orb.scale_factor,
                cell=self.cfg.orb.cell_size,
            )
            self._stereo_initialize(frame, t)
        else:
            self._track(img_l, img_r, t)
        # poses stay on device; converted in bulk at evaluation time
        self._record_frame(t)
        return self.state

    # ------------------------------------------------------------------
    def _stereo_initialize(self, frame: frontend.Frame, t: float) -> None:
        """StereoInitialization analog (``Tracking.cc:2236``): need enough
        stereo depths, then KF0 at the current pose with depth landmarks."""
        n_depth = int(torch.sum((frame.depth > 0) & frame.valid))
        if n_depth < 100:
            return
        self._insert_keyframe(frame, t, lm_feat=None)
        self.state = TrackingState.OK
        self.inliers_at_last_kf = n_depth

    def _track(self, img_l, img_r, t: float):
        """Deferred-decision tracking: the device step for each frame is
        dispatched immediately; the host-side branching (lost / keyframe
        decision) is resolved in batches of ``decision_batch`` frames with
        one double-buffered device-to-host read, so decisions lag the
        dispatch by up to 2 x ``decision_batch`` frames."""
        cam = self.cfg.camera
        # the prediction's pose and velocity flag are taken before the
        # frame's background slice, as the reference takes them: a loop
        # correction in that slice re-bases the live pose for the NEXT frame
        R_last, t_last, has_vel = self.R_cw, self.t_cw, self._vel_flag[self.has_velocity]
        self._service_background()
        with self.timer.span("track/dispatch"):
            out = tracking.full_frame_step(
                self.ms, img_l, img_r, R_last, t_last,
                self.vel_R, self.vel_t, has_vel,
                self.cam_params,
                bf=cam.bf, w=cam.width, h=cam.height,
                scale=self.cfg.orb.scale_factor,
                n_levels=self.cfg.orb.n_levels,
                n_features=self.cfg.orb.n_features,
                cell=self.cfg.orb.cell_size,
                min_inliers=self.cfg.tracking.min_inliers_local_map,
                far_dist=self.cfg.camera.th_far_points,
            )
        self._after_dispatch(out, t)
        return out

    def _after_dispatch(self, out, t: float) -> None:
        """Post-dispatch bookkeeping + the batched decision pipeline: the
        inlier counts of ``decision_batch`` consecutive frames are stacked
        into one tensor and copied to the host with one non-blocking copy,
        consumed one batch later (or as soon as it has landed)."""
        ms, frame, tr, R_new, t_new, vel_R, vel_t, _ = out
        self.ms = ms
        self.R_cw, self.t_cw = R_new, t_new
        self.vel_R, self.vel_t = vel_R, vel_t
        self.has_velocity = True
        self.frames_since_kf += 1
        self._dispatch_idx += 1
        q = self._pending_decisions
        q.append((frame, tr, t, self._dispatch_idx, self._map_gen))
        if self.state != TrackingState.OK:
            # while degraded, latency is irrelevant: decide synchronously so
            # lost-streak counting acts on THIS frame
            self.flush_decisions()
            return
        B = self.decision_batch
        if len(q) >= B:
            batch, self._pending_decisions = q[:B], q[B:]
            read = _HostRead(torch.stack([it[1].n_inliers for it in batch]))
            inflight = self._inflight_decisions
            self._inflight_decisions = (batch, read)
            if inflight is not None:
                self._consume_decisions(*inflight)
        else:
            # opportunistic consume: act on the inflight batch if its read
            # has already landed, never blocking the dispatch path
            inflight = self._inflight_decisions
            if inflight is not None and inflight[1].is_ready():
                self._inflight_decisions = None
                self._consume_decisions(*inflight)

    def _consume_decisions(self, batch, read: _HostRead) -> None:
        with self.timer.span("track/decide_sync"):
            ns = read.numpy()
        for j, ((frame, tr, t, di, gen), n) in enumerate(zip(batch, ns)):
            if gen != self._map_gen:
                # decided before a map reset: tr.lm_feat indexes a dead
                # map's landmark slots
                continue
            self._decide(frame, tr, t, n_inliers=int(n), dispatch_idx=di)
            if self._map_gen != gen:
                # this decision reset the map: the remaining queued steps
                # target the OLD map
                self._replay_stale(batch[j + 1:])
                return

    def _replay_stale(self, tail) -> None:
        """Re-track frames whose dispatched device steps targeted a previous
        map, against the new active map; after a hard reset they are
        dropped (the fresh map needs initialization frames)."""
        entries = list(tail)
        inflight = self._inflight_decisions
        self._inflight_decisions = None
        if inflight is not None:
            entries.extend(inflight[0])
        entries.extend(self._pending_decisions)
        self._pending_decisions = []
        if self.state != TrackingState.OK:
            return
        for e in entries:
            self._track_with_frame(e[0], e[2])

    def flush_decisions(self) -> None:
        """Resolve deferred decisions and the pending loop detection, and
        run every queued mapping and GBA slice (call at sequence end)."""
        inflight = self._inflight_decisions
        self._inflight_decisions = None
        if inflight is not None:
            self._consume_decisions(*inflight)
        q = self._pending_decisions
        self._pending_decisions = []
        if q:
            self._consume_decisions(q, _HostRead(torch.stack([it[1].n_inliers for it in q])))
        self._maybe_close_loop(flush=True)
        while self._bg_queue or self._gba_chunks_left > 0:
            self._service_background()

    def _decide(self, frame, tr, t: float, n_inliers=None, dispatch_idx=None) -> None:
        """Host branching for an already-computed frame step.

        dispatch_idx: the frame's dispatch index snapshot; the KF gap is
        ``dispatch_idx - last-inserted-KF's dispatch_idx`` so that an
        insertion earlier in the same consumed batch does not suppress the
        remaining decisions."""
        if n_inliers is None:
            with self.timer.span("track/decide_sync"):
                n_inliers = int(tr.n_inliers)
        if n_inliers < self.cfg.tracking.min_inliers_local_map:
            with self.timer.span("track/lost"):
                self._handle_lost(frame)
            return
        self.n_lost_frames = 0
        self.state = TrackingState.OK
        gap = dispatch_idx - self._last_kf_dispatch_idx if dispatch_idx is not None else None
        if self._need_new_keyframe(frame, n_inliers, gap):
            # the keyframe is inserted with ITS OWN tracked pose; the live
            # pose is restored relatively (T_live ∘ T_kf⁻¹ re-applied)
            R_rel, t_rel = lie.se3_rel(self.R_cw, self.t_cw, tr.R_cw, tr.t_cw)
            self.R_cw, self.t_cw = tr.R_cw, tr.t_cw
            self._cur_track_inliers = n_inliers
            with self.timer.span("mapping/insert_kf"):
                self._insert_keyframe(frame, t, lm_feat=tr.lm_feat)
            self.R_cw, self.t_cw = lie.se3_compose_j(R_rel, t_rel, self.R_cw, self.t_cw)
            self.inliers_at_last_kf = n_inliers
            if dispatch_idx is not None:
                self._last_kf_dispatch_idx = dispatch_idx

    # ------------------------------------------------------------------
    # Lost path and Atlas elasticity (Tracking::CreateMapInAtlas /
    # ResetActiveMap)
    # ------------------------------------------------------------------
    def _handle_lost(self, frame) -> None:
        """Relocalize, else degrade; on hard loss either reset a young map
        or shelve a mature one and start fresh (``Tracking.cc:1930-1948``)."""
        if self._relocalize(frame):
            self.n_lost_frames = 0
            self.state = TrackingState.OK
            return
        self.n_lost_frames += 1
        # without an IMU the prediction decays fast: ~1 s of attempts
        budget = 20
        if self.n_lost_frames < budget:
            self.state = TrackingState.RECENTLY_LOST
            self.has_velocity = False
            return
        self.state = TrackingState.LOST
        self.has_velocity = False
        if self.n_lost_frames == budget:  # act once on the transition
            if self.n_kf >= 10:
                self._create_map_in_atlas()
            else:
                self._reset_active_map()

    def _create_map_in_atlas(self) -> None:
        """Shelve the active map and start a fresh one. The shelf keeps the
        map's BoW database (relocalization searches it); the reference's
        merge prior belongs to the Atlas merge, which is not ported."""
        # complete pending BoW inserts so the shelved database covers every
        # keyframe; refinement slices are dropped with the queue on reset
        for kind, fn in list(self._bg_queue):
            if kind == "bow_insert":
                fn()
        self.atlas_maps.append({
            "ms": self.ms,
            "n_kf": self.n_kf,
            "loop_closer": self.loop_closer,
            "traj_end": len(self.trajectory),
            "gen": self._map_gen,
            "kf_times": list(self._host_kf_times()),
            "kf_lowq": list(self._kf_lowq_host),
        })
        self._reset_active_map()

    def _reset_active_map(self) -> None:
        cap = self.cfg.capacity
        self.ms = msx.empty_map(cap.max_keyframes, self.n_feat, cap.max_landmarks,
                                device=self.device)
        self.loop_closer = self._new_loop_closer()
        self.n_kf = 0
        self._kf_times_host = []
        self._kf_lowq_host = []
        self.frames_since_kf = 0
        self._last_kf_dispatch_idx = self._dispatch_idx
        self.inliers_at_last_kf = 0
        self.n_lost_frames = 0
        self.state = TrackingState.NOT_INITIALIZED
        self.has_velocity = False
        # queued mapping slices and pending GBA target the OLD map
        self._bg_queue = []
        self._gba_chunks_left = 0
        self._gba_prev_cost = None
        self._gen_counter += 1
        self._map_gen = self._gen_counter

    def _relocalize(self, frame: frontend.Frame) -> bool:
        """BoW candidates + PnP RANSAC (Tracking::Relocalization), in the
        active map and then in the shelved maps, newest first; a pose found
        in a shelved map switches back to it."""
        pose = self._relocalize_in(frame, self.ms, self.loop_closer, self.n_kf)
        if pose is not None:
            self.R_cw, self.t_cw = pose
            self.has_velocity = False
            return True
        for idx in range(len(self.atlas_maps) - 1, -1, -1):
            shelf = self.atlas_maps[idx]
            if shelf.get("loop_closer") is None:
                continue
            pose = self._relocalize_in(frame, shelf["ms"], shelf["loop_closer"], shelf["n_kf"])
            if pose is not None:
                self._switch_to_shelved(idx)
                self.R_cw, self.t_cw = pose
                self.has_velocity = False
                return True
        return False

    def _relocalize_in(self, frame, ms, lc, n_kf):
        """One map's attempt: BoW scores over the whole database (one host
        read), covisibility-group candidates, then PnP RANSAC and guided
        verification per candidate until one passes. Returns (R_cw, t_cw)
        or None."""
        if lc.vocab is None or n_kf < 1:
            return None
        q_ids, q_wts = voc.sparse_bow_soft_from_desc(lc.vocab, frame.desc, frame.valid)
        scores = voc.sparse_l1_score(q_ids, q_wts, lc.db_words, lc.db_wts).cpu().numpy().copy()
        scores[n_kf:] = -1.0
        if float(scores.max()) < 0.05:
            return None
        for cand in self._reloc_candidates(ms, scores, n_kf):
            pose = self._reloc_attempt(frame, ms, cand)
            if pose is not None:
                return pose
        return None

    #: candidate groups tried per map (DetectNBestCandidates' nNumCandidates)
    _RELOC_TOP_K = 3

    def _reloc_candidates(self, ms, scores, n_kf):
        if n_kf == 1:
            return [0]
        cov = msx.covisibility_weights(ms, torch.arange(ms.K, device=self.device)).cpu().numpy()
        return reloc_candidate_groups(cov[:n_kf, :n_kf], scores[:n_kf], top_k=self._RELOC_TOP_K)

    def _reloc_attempt(self, frame, ms, cand: int):
        """One candidate: descriptor match -> PnP RANSAC -> two guided
        tracking rounds (``Tracking.cc:3801-3940``). Returns (R_cw, t_cw)
        or None."""
        vb = ms.kf_feat_valid[cand] & (ms.obs_lm[cand] >= 0)
        res = matching.match_nn_ratio(frame.desc, ms.kf_desc[cand], frame.valid, vb,
                                      max_dist=60, ratio=0.8)
        feat_b = torch.clamp(res.idx, min=0).to(torch.int64)
        lm = ms.obs_lm[cand, feat_b]
        ok3d = res.valid & (lm >= 0)
        X = ms.lm_pos[torch.clamp(lm, min=0).to(torch.int64)]
        R, t, _, n = ransac.pnp_ransac(X, frame.xy, ok3d, self.cam_params, self._split_key(),
                                       n_hyp=192, inlier_px=6.0)
        if int(n) < 15:
            return None
        # guided refinement: track the whole map from the PnP pose, twice,
        # and require a solid inlier count
        cam = self.cfg.camera
        for _ in range(2):
            tr = tracking.track_frame(
                ms, frame, R, t, self.cam_params, cam.bf, w=cam.width, h=cam.height,
                scale=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
                cam_model=self.cam_model,
            )
            R, t = tr.R_cw, tr.t_cw
        if int(tr.n_inliers) < max(50, self.cfg.tracking.min_inliers_local_map):
            return None
        return tr.R_cw, tr.t_cw

    def _switch_to_shelved(self, idx: int) -> None:
        """Re-activate a shelved Atlas map; the active map is shelved in
        its place if mature, else dropped."""
        shelf = self.atlas_maps.pop(idx)
        for kind, fn in list(self._bg_queue):
            if kind == "bow_insert":
                fn()
        if self.n_kf >= 5:
            self.atlas_maps.append({
                "ms": self.ms,
                "n_kf": self.n_kf,
                "loop_closer": self.loop_closer,
                "traj_end": len(self.trajectory),
                "gen": self._map_gen,
                "kf_times": list(self._host_kf_times()),
                "kf_lowq": list(self._kf_lowq_host),
            })
        self.ms = shelf["ms"]
        self.n_kf = shelf["n_kf"]
        self._kf_times_host = list(shelf.get("kf_times") or self.ms.kf_time[: self.n_kf].cpu().numpy())
        self._kf_lowq_host = list(shelf.get("kf_lowq") or [False] * self.n_kf)
        self.loop_closer = shelf["loop_closer"]
        self._map_gen = shelf["gen"]
        # queued mapping slices captured indices of the map switched away from
        self._bg_queue = []
        self._gba_chunks_left = 0
        self._gba_prev_cost = None
        self.frames_since_kf = 0
        self._last_kf_dispatch_idx = self._dispatch_idx
        self.n_lost_frames = 0

    # ------------------------------------------------------------------
    # Background mapping FIFO: every per-keyframe job (duplicate fusion,
    # local-BA slices, culling) is a bounded device slice, one serviced
    # ahead of each subsequent frame dispatch.
    # ------------------------------------------------------------------
    def _bg_push(self, kind: str, fn) -> None:
        self._bg_queue.append((kind, fn))

    def _bg_drop(self, kinds) -> None:
        self._bg_queue = [(k, f) for (k, f) in self._bg_queue if k not in kinds]

    def _schedule_local_ba(self, kf_idx: int, chunks: int = 2) -> None:
        """Queue the per-KF local BA as bounded slices serviced one per
        subsequent frame dispatch. A newer keyframe aborts the previous
        window's remaining slices (the ``mbAbortBA`` preemption,
        ``LocalMapping.cc:115``)."""
        self._bg_drop(("local_ba_chunk",))
        for _ in range(chunks):
            self._bg_push("local_ba_chunk", functools.partial(self._lba_slice, kf_idx))

    def _lba_slice(self, kf_idx: int) -> None:
        cam = self.cfg.camera
        self.ms = tracking.local_ba_step(
            self.ms, kf_idx, self.cam_params,
            cam.bf, window=min(8, self.cfg.capacity.max_local_kfs),
            lm_cap=self.cfg.capacity.max_local_landmarks,
            iters=2, cam_model=self.cam_model,
        )

    #: queued-slice backpressure: past this depth the inserting keyframe
    #: services slices inline until the queue fits
    _BG_QUEUE_MAX = 8

    def _bg_backpressure(self) -> None:
        while len(self._bg_queue) > self._BG_QUEUE_MAX:
            kind, fn = self._bg_queue.pop(0)
            with self.timer.span(f"mapping/{kind}"):
                fn()

    def _service_background(self) -> None:
        """One background slice per frame dispatch: queued per-KF mapping
        jobs first, then any pending GBA slice."""
        if self._bg_queue:
            kind, fn = self._bg_queue.pop(0)
            with self.timer.span(f"mapping/{kind}"):
                fn()
        else:
            self._service_gba()

    def _service_gba(self) -> None:
        """Dispatch one pending GBA slice (2 LM iterations over the whole
        map) and adapt the remaining budget to its cost."""
        if self._gba_chunks_left > 0:
            with self.timer.span("mapping/gba_chunk"):
                self.ms, cost = self.loop_closer.gba_chunk(
                    self.ms, self.cam_params, self.cfg.camera.bf, cam_model=self.cam_model,
                )
            self._gba_chunks_left -= 1
            self._gba_chunks_run += 1
            self._adapt_gba_budget(cost)

    # GBA convergence control: each chunk returns its final chi² sum;
    # converged -> cancel the remaining chunks, still descending on the last
    # scheduled chunk -> extend (bounded)
    _GBA_CHUNKS_MAX = 12
    _GBA_REL_TOL = 1e-3

    def _adapt_gba_budget(self, cost) -> None:
        if cost is None:
            return
        cost = float(cost)  # one host read per chunk
        # chi² sums compare only between chunks over the same observations
        sig = (
            self._map_gen, self.n_kf, self.stats["kf_inserted"],
            self.stats["kf_culled"], self.stats["kf_evicted"],
        )
        prev_rec = self._gba_prev_cost
        self._gba_prev_cost = (cost, sig)
        if prev_rec is None:
            return
        prev, prev_sig = prev_rec
        if prev_sig != sig or prev <= 0.0:
            return
        rel = (prev - cost) / prev
        if rel < self._GBA_REL_TOL:
            self._gba_chunks_left = 0  # converged (or oscillating): stop
        elif (self._gba_chunks_left == 0
              and self._gba_chunks_run < self._GBA_CHUNKS_MAX
              and rel > 0.02):
            self._gba_chunks_left = 2  # still descending: extend the solve

    def _track_with_frame(self, frame: frontend.Frame, t: float) -> None:
        """Unfused, synchronous track path for pre-extracted frames (the
        replay of stale decisions after a map switch)."""
        cam = self.cfg.camera
        self._service_background()
        if self.has_velocity:
            R_pred, t_pred = lie.se3_compose(self.vel_R, self.vel_t, self.R_cw, self.t_cw)
        else:
            R_pred, t_pred = self.R_cw, self.t_cw
        tr = tracking.track_frame(
            self.ms, frame, R_pred, t_pred, self.cam_params, cam.bf,
            w=cam.width, h=cam.height,
            scale=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            cam_model=self.cam_model, far_dist=self.cfg.camera.th_far_points,
        )
        n_inliers = int(tr.n_inliers)
        if n_inliers < self.cfg.tracking.min_inliers_local_map:
            self._handle_lost(frame)
            return
        self.n_lost_frames = 0
        self.state = TrackingState.OK
        Ri, ti = lie.se3_inverse(self.R_cw, self.t_cw)
        self.vel_R, self.vel_t = lie.se3_compose(tr.R_cw, tr.t_cw, Ri, ti)
        self.has_velocity = True
        self.R_cw, self.t_cw = tr.R_cw, tr.t_cw
        self.ms = tracking.update_landmark_stats(self.ms, tr)
        self.frames_since_kf += 1
        if self._need_new_keyframe(frame, n_inliers):
            self._cur_track_inliers = n_inliers
            self._insert_keyframe(frame, t, lm_feat=tr.lm_feat)
            self.inliers_at_last_kf = n_inliers

    # ------------------------------------------------------------------
    # Mapping slices
    # ------------------------------------------------------------------
    def _cull_landmarks_slice(self) -> None:
        self.ms = tracking.cull_landmarks(self.ms)

    def _cull_redundant_slice(self) -> None:
        # anchors 0 and 1 and the two newest keyframes, as device compares
        kk = torch.arange(self.ms.K, device=self.device)
        protect = (kk == 0) | (kk == 1)
        protect = protect | (kk == max(self.n_kf - 1, 0)) | (kk == max(self.n_kf - 2, 0))
        self.ms = tracking.cull_redundant_keyframes(self.ms, protect)

    def _fuse_new_duplicates(self, kf_idx: int) -> None:
        """Duplicate-landmark fusion for the newest keyframe's spawns
        (LocalMapping::SearchInNeighbors -> ORBmatcher::Fuse,
        ``LocalMapping.cc:955``)."""
        new_mask = self.ms.lm_valid & (self.ms.lm_first_kf == kf_idx)
        radius = max(0.5 * self.baseline, 0.02) if self.baseline > 0 else 0.05
        self.ms, _ = map_merging.fuse_duplicate_landmarks(self.ms, new_mask, radius=radius)

    def _need_new_keyframe(self, frame: frontend.Frame, n_inliers: int, gap: int = None) -> bool:
        """KF decision (``Tracking.cc:3078-3273``, simplified visual c1/c2):
        enough frames passed, or tracking weakened vs the reference KF.

        gap: frames between the DECIDED frame and the last inserted KF;
        defaults to the live counter for synchronous paths."""
        tc = self.cfg.tracking
        if gap is None:
            gap = self.frames_since_kf
        if self.n_kf >= self.ms.K - 1:
            return False
        if gap < max(tc.min_frames_between_kf, 1):
            return False
        c1 = gap >= tc.max_frames_between_kf
        c2 = n_inliers < tc.kf_ref_ratio * max(self.inliers_at_last_kf, 1)
        c3 = n_inliers < 2 * tc.min_inliers_local_map  # tracking getting thin
        return c1 or c2 or c3

    def _host_kf_times(self) -> np.ndarray:
        """Keyframe timestamps without a device read: the host-side mirror
        kept at insertion/compaction, with one device pull when it is out
        of step."""
        kt = self._kf_times_host
        if len(kt) != self.n_kf:
            kt = list(self.ms.kf_time[: self.n_kf].cpu().numpy())
            self._kf_times_host = kt
        return np.asarray(kt)

    def _reclaim_kf_slots(self) -> None:
        """Capacity-pressure keyframe reclamation: aggressive redundancy
        culling, slot compaction (``map_state.compact_keyframes``), and --
        only if nothing was redundant -- covisibility-aware eviction
        (reference ``LocalMapping.cc:1194-1399``). Reads the device."""
        K = self.ms.K
        protect = np.zeros((K,), bool)
        protect[0] = True
        for d in range(1, 5):
            protect[max(self.n_kf - d, 0)] = True
        n_before = self.n_kf
        self.stats["reclaims"] += 1
        # queued slices capture pre-compaction slot indices: BoW inserts
        # and loop slices run now (the consistency gate counts consecutive
        # keyframes); refinement slices are dropped -- the next keyframe
        # reschedules fresh ones
        keep = [it for it in self._bg_queue if it[0] in ("bow_insert", "loop")]
        self._bg_queue = []
        for kind, fn in keep:
            with self.timer.span(f"mapping/{kind}"):
                fn()
        protect_t = torch.from_numpy(protect).to(self.device)
        self.ms = tracking.cull_redundant_keyframes(
            self.ms, protect_t, max_cull=8, redundancy=0.75,
        )
        ms2, new_of_old, n_valid = msx.compact_keyframes(self.ms)
        nv = int(n_valid)
        self.stats["kf_culled"] += n_before - nv
        if nv >= K - 2:
            # nothing redundant enough: evict from the densest covisible
            # cluster, never from the live window (slots covisible with the
            # newest keyframe still support tracking)
            cov = msx.covisibility_weights(
                self.ms, torch.arange(K, device=self.device)
            ).cpu().numpy()
            protect_live = cov[max(self.n_kf - 1, 0)] >= 15
            evict = select_eviction_slots(
                cov, protect, self.n_kf, n_evict=5, protect_soft=protect_live,
            )
            self.stats["kf_evicted"] += int(evict.sum())
            evict_t = torch.from_numpy(evict).to(self.device)
            self.ms = self.ms._replace(
                kf_valid=self.ms.kf_valid & ~evict_t,
                obs_lm=torch.where(evict_t[:, None], -1, self.ms.obs_lm),
            )
            ms2, new_of_old, n_valid = msx.compact_keyframes(self.ms)
            nv = int(n_valid)
        self.ms = ms2
        noo = new_of_old.cpu().numpy()
        self.loop_closer.compact(noo)
        # host-side timestamp + quality mirrors follow the slot compaction
        kt = self._host_kf_times()
        new_times = np.zeros((nv,), np.float64)
        for old, new in enumerate(noo[: len(kt)]):
            if new < K and new < nv:
                new_times[new] = kt[old]
        self._kf_times_host = list(new_times)
        lowq = self._kf_lowq_host
        new_lowq = [False] * nv
        for old, new in enumerate(noo[: len(lowq)]):
            if new < K and new < nv:
                new_lowq[new] = lowq[old]
        self._kf_lowq_host = new_lowq
        # remap this map's trajectory references; culled refs fall back to
        # their absolute record-time poses
        gen = self._map_gen
        self.trajectory = [
            (t, g, int(noo[kf]) if (g == gen and kf >= 0 and noo[kf] < K)
             else (-1 if g == gen else kf),
             R_rel, t_rel, R_abs, t_abs)
            for (t, g, kf, R_rel, t_rel, R_abs, t_abs) in self.trajectory
        ]
        self.n_kf = nv

    def _insert_keyframe_visual_only(self, frame: frontend.Frame, t: float, lm_feat) -> None:
        """make_keyframe + bookkeeping, no mapping step."""
        if self.n_kf >= self.ms.K - 2:
            self._reclaim_kf_slots()
        cam = self.cfg.camera
        if lm_feat is None:
            lm_feat = torch.full((self.ms.L,), -1, dtype=torch.int32, device=self.device)
        # StereoInitialization spawns ALL depth-positive points
        # (Tracking.cc:2236); later keyframes only close ones + nearest-100
        depth_far = float("inf") if self.n_kf == 0 else cam.th_depth * self.baseline
        self.ms = tracking.make_keyframe(
            self.ms, frame, self.R_cw, self.t_cw, float(t), self.n_kf,
            lm_feat, self.cam_params, depth_far,
            scale=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            cam_model=self.cam_model,
        )
        self.stats["kf_inserted"] += 1
        self._kf_times_host = self._kf_times_host[: self.n_kf] + [float(t)]
        # tracked-inlier quality at insertion, mirrored per KF slot
        ni = self._cur_track_inliers
        self._cur_track_inliers = None
        lowq = ni is not None and ni < 2 * self.cfg.tracking.min_inliers_local_map
        self._kf_lowq_host = self._kf_lowq_host[: self.n_kf] + [bool(lowq)]
        kf_idx_host = self.n_kf
        self.n_kf += 1
        self.frames_since_kf = 0
        # synchronous insertion paths (init / _track_with_frame): the KF is
        # the CURRENT frame; batched _decide overrides with its snapshot
        self._last_kf_dispatch_idx = self._dispatch_idx
        if self.enable_loop_closing:
            # BoW database insert (KeyFrameDatabase::add) rides the FIFO, so
            # it lands before any detection queued for this keyframe
            self._bg_push("bow_insert", functools.partial(
                self.loop_closer.add_keyframe, kf_idx_host, frame.desc, frame.valid))

    def _loop_gate_allows(self, kf_idx: int, cand: int, R_d, t_d, s_d, mode: str) -> bool:
        """Drift-plausibility gate: a loop correction's displacement of the
        current keyframe may not exceed the drift the trajectory could have
        accumulated since the candidate: 15 % of each segment's arc, 50 %
        where its keyframes were inserted under degraded tracking (mono
        40 % / 80 %), plus ten baselines. One host read (the pose segment
        and the warp together)."""
        lo, hi = (cand, kf_idx) if cand <= kf_idx else (kf_idx, cand)
        n = hi - lo + 1
        host = torch.cat([
            self.ms.kf_R_cw[lo:hi + 1].reshape(-1), self.ms.kf_t_cw[lo:hi + 1].reshape(-1),
            R_d.reshape(-1), t_d.reshape(-1), s_d.reshape(-1),
        ]).cpu().numpy()
        Rseg = host[: 9 * n].reshape(n, 3, 3)
        tseg = host[9 * n: 12 * n].reshape(n, 3)
        R_dh = host[12 * n: 12 * n + 9].reshape(3, 3)
        t_dh = host[12 * n + 9: 12 * n + 12]
        s_dh = float(host[12 * n + 12])
        centers = -np.einsum("kji,kj->ki", Rseg, tseg)
        seg_len = np.linalg.norm(np.diff(centers, axis=0), axis=1)
        c_cur = centers[-1] if cand <= kf_idx else centers[0]
        disp = float(np.linalg.norm(s_dh * (R_dh @ c_cur) + t_dh - c_cur))
        frac, frac_lowq = (0.4, 0.8) if mode == "sim3" else (0.15, 0.5)
        q = self._kf_lowq_host
        lowq = np.zeros((n,), bool)
        for i in range(lo, min(hi + 1, len(q))):
            lowq[i - lo] = bool(q[i])
        rate = np.where(lowq[1:] | lowq[:-1], frac_lowq, frac)
        allowed = float((rate * seg_len).sum()) + 10.0 * max(self.baseline, 0.01)
        return disp <= allowed

    def _maybe_close_loop(self, flush: bool = False) -> None:
        """Detect + verify + correct (LoopClosing::Run per keyframe).

        Detection is deferred by one keyframe: the scores dispatched at
        keyframe k are read when keyframe k+1's loop slice runs. A BoW hit
        seeds a hypothesis by a full verification; a live hypothesis is
        refined against each new keyframe and accepted after enough
        confirmations; a consistent BoW streak verifies its candidate and
        up to two alternates. An accepted loop passes the drift gate, is
        corrected (SE(3) essential graph), followed by duplicate fusion of
        the recent landmarks, the re-basing of the live pose and four GBA
        slices."""
        if not self.enable_loop_closing:
            return
        if flush:
            kf_idx, cand = self.loop_closer.poll_detect()
        else:
            kf_idx, cand = self.loop_closer.detect_async(self.ms, self.n_kf - 1, self.n_kf)
        # stereo maps take the SE(3) essential graph (LoopClosing.cc:1239-1245)
        mode = "se3"
        lc = self.loop_closer
        ok = False
        if cand < 0:
            if lc._hyp is not None:
                acc, c_h, R_d, t_d, s_d = lc.hypothesis_step(
                    self.ms, self.n_kf - 1, self.cam_params, cam_model=self.cam_model,
                    fix_scale=True,
                )
                if not acc:
                    return
                kf_idx, cand, ok = self.n_kf - 1, c_h, True
                lc._closure_src = "hyp"
            elif kf_idx >= 0 and lc._consecutive == 1 and lc._last_cand >= 0:
                # a fresh unconfirmed BoW hit seeds a hypothesis with a full
                # geometric verification
                ok_seed, R_s, t_s, s_s = lc.verify(
                    self.ms, kf_idx, lc._last_cand, self._split_key(), fix_scale=True,
                    cam_params=self.cam_params, cam_model=self.cam_model,
                )
                if ok_seed:
                    lc.start_hypothesis(lc._last_cand, R_s, t_s, s_s)
                return
            else:
                return
        if not ok:
            for c in [cand] + [c for c in lc._alternates if c >= 0][:2]:
                ok, R_d, t_d, s_d = lc.verify(
                    self.ms, kf_idx, c, self._split_key(), fix_scale=True,
                    cam_params=self.cam_params, cam_model=self.cam_model,
                )
                if ok:
                    cand = c
                    lc._closure_src = "bow"
                    break
        if not ok:
            return
        if not self._loop_gate_allows(kf_idx, cand, R_d, t_d, s_d, mode):
            self.stats["loops_rejected_gate"] = self.stats.get("loops_rejected_gate", 0) + 1
            lc._hyp = None
            lc._consecutive = 0
            return
        R_kf_old = self.ms.kf_R_cw[kf_idx]
        t_kf_old = self.ms.kf_t_cw[kf_idx]
        self.ms = lc.correct(
            self.ms, self.n_kf, kf_idx, cand, R_d, t_d, self.cam_params, self.cfg.camera.bf,
            mode=mode, s_delta=s_d, run_gba=False,
        )
        # GBA as bounded slices between the next frames' dispatches
        self._gba_chunks_left = 4
        self._gba_chunks_run = 0
        self._gba_prev_cost = None
        # SearchAndFuse: the two loop sides now overlap, so landmarks born
        # on the current side that coincide with loop-side ones merge
        recent = self.ms.lm_valid & (self.ms.lm_first_kf >= max(kf_idx - 10, 0))
        radius = max(0.5 * self.baseline, 0.02) if self.baseline > 0 else 0.05
        self.ms, _ = map_merging.fuse_duplicate_landmarks(self.ms, recent, radius=radius)
        # re-base the live pose onto the corrected map:
        # T_track' = T_track ∘ T_kf_old⁻¹ ∘ T_kf_new
        Ri, ti = lie.se3_inverse(R_kf_old, t_kf_old)
        Rm, tm = lie.se3_compose(Ri, ti, self.ms.kf_R_cw[kf_idx], self.ms.kf_t_cw[kf_idx])
        self.R_cw, self.t_cw = lie.se3_compose(self.R_cw, self.t_cw, Rm, tm)
        self.has_velocity = False

    def _insert_keyframe(self, frame: frontend.Frame, t: float, lm_feat) -> None:
        self._insert_keyframe_visual_only(frame, t, lm_feat)
        if self.n_kf >= 2:
            # every per-KF mapping job is a bounded slice on the background
            # FIFO, one dispatched ahead of each subsequent frame
            kf_host = self.n_kf - 1
            self._bg_push("fuse", functools.partial(self._fuse_new_duplicates, kf_host))
            self._schedule_local_ba(kf_host)
            self._bg_push("cull_lm", self._cull_landmarks_slice)
            # redundant-KF culling, every 3rd keyframe
            if self.n_kf > 6 and kf_host % 3 == 0:
                self._bg_drop(("cull_kf",))
                self._bg_push("cull_kf", self._cull_redundant_slice)
            self._bg_push("loop", self._maybe_close_loop)
            if self.atlas_maps and self.enable_loop_closing:
                # the reference probes every new keyframe against the
                # shelved maps here (map_merging.try_merge)
                raise NotImplementedError("Atlas merge is not ported")
            # the live tracking pose is deliberately NOT overwritten by the
            # BA result: the tracker re-aligns at the next frame
            self._bg_backpressure()

    # ------------------------------------------------------------------
    def _record_frame(self, t: float) -> None:
        """Append one trajectory record (relative to the newest keyframe)."""
        kf = self.n_kf - 1
        if kf >= 0:
            R_rel, t_rel = lie.se3_rel(self.R_cw, self.t_cw, self.ms.kf_R_cw[kf], self.ms.kf_t_cw[kf])
        else:
            R_rel = t_rel = None
        self.trajectory.append((t, self._map_gen, kf, R_rel, t_rel, self.R_cw, self.t_cw))

    def trajectory_arrays(self):
        """(times [T], positions_wc [T,3], R_wc [T,3,3]) for evaluation.

        Frame poses are recovered as T_rel ∘ T_kf(final): the reference's
        trajectory-writer scheme (``System.cc:503``). One device read per
        quantity."""
        gen_pose = {self._map_gen: (self.ms.kf_R_cw, self.ms.kf_t_cw)}
        for shelf in self.atlas_maps:
            gen_pose[shelf["gen"]] = (shelf["ms"].kf_R_cw, shelf["ms"].kf_t_cw)
        gen_pose = {g: (R.cpu().numpy(), t.cpu().numpy()) for g, (R, t) in gen_pose.items()}

        def pull(arrs):
            return torch.stack(arrs).cpu().numpy() if arrs else np.zeros((0,))

        rel_idx = [i for i, rec in enumerate(self.trajectory) if rec[3] is not None]
        R_rel_h = dict(zip(rel_idx, pull([self.trajectory[i][3] for i in rel_idx])))
        t_rel_h = dict(zip(rel_idx, pull([self.trajectory[i][4] for i in rel_idx])))
        R_abs_h = pull([rec[5] for rec in self.trajectory])
        t_abs_h = pull([rec[6] for rec in self.trajectory])
        ts, Rs, tt = [], [], []
        for i, (t, gen, kf, _, _, _, _) in enumerate(self.trajectory):
            ts.append(t)
            if kf >= 0 and gen in gen_pose and i in R_rel_h:
                Rk, tk = gen_pose[gen][0][kf], gen_pose[gen][1][kf]
                Rr = R_rel_h[i]
                Rs.append(Rr @ Rk)
                tt.append(Rr @ tk + t_rel_h[i])
            else:
                Rs.append(R_abs_h[i])
                tt.append(t_abs_h[i])
        ts = np.array(ts)
        Rs = np.stack(Rs)
        tt = np.stack(tt)
        R_wc = np.transpose(Rs, (0, 2, 1))
        centers = -np.einsum("tij,tj->ti", R_wc, tt)
        return ts, centers, R_wc

    def keyframe_trajectory_arrays(self):
        """(times, centers_wc, R_wc) of the VALID keyframes of the active
        map (SaveKeyFrameTrajectoryEuRoC source data)."""
        n = self.n_kf
        valid = self.ms.kf_valid[:n].cpu().numpy()
        ts = self.ms.kf_time[:n].cpu().numpy()[valid]
        Rs = self.ms.kf_R_cw[:n].cpu().numpy()[valid]
        tt = self.ms.kf_t_cw[:n].cpu().numpy()[valid]
        R_wc = np.transpose(Rs, (0, 2, 1))
        centers = -np.einsum("tij,tj->ti", R_wc, tt)
        return ts, centers, R_wc

    def save_trajectory(self, path: str, fmt: str = "tum") -> None:
        """Write the per-frame trajectory (System::SaveTrajectory{TUM,
        EuRoC,KITTI}). fmt: tum | euroc | kitti."""
        from orb_slam3_detailed_comments_kor_tpu_torch.io import trajectory as tio

        ts, centers, R_wc = self.trajectory_arrays()
        getattr(tio, f"save_{fmt}")(path, ts, centers, R_wc)

    def save_keyframe_trajectory(self, path: str, fmt: str = "tum") -> None:
        """Write the keyframe trajectory (System::SaveKeyFrameTrajectory*)."""
        from orb_slam3_detailed_comments_kor_tpu_torch.io import trajectory as tio

        ts, centers, R_wc = self.keyframe_trajectory_arrays()
        getattr(tio, f"save_{fmt}")(path, ts, centers, R_wc)

    def map_stats(self):
        return {
            "n_keyframes": int(torch.sum(self.ms.kf_valid)),
            "n_landmarks": int(torch.sum(self.ms.lm_valid)),
            "n_frames": self.n_frames,
            "n_maps": 1 + len(self.atlas_maps),
        }
