"""Host-side SLAM system facade + tracking state machine.

Port of ``orb_slam3_detailed_comments_kor_tpu/slam/system.py``, every
sensor path: stereo, stereo-inertial, monocular and monocular-inertial
pinhole, RGB-D, and the KB8 fisheye (monocular, or a two-camera rig with or
without an IMU):
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
batched decision read, in ``_reclaim_kf_slots``, on the lost path, when a
map is shelved (its merge prior), and in a loop or merge slice where the
reference does (a verification's or hypothesis step's inlier count, the
drift gate's pose segment, the closure's log line, a GBA slice's cost, the
merge's scores, gate and remap). Background mapping work runs as bounded
slices, one ahead of each frame's dispatch (``_service_background``), so a
frame never waits behind a whole solve.

Also here: the Atlas merge (``map_merging.try_merge``, queued per keyframe
while shelved maps exist), localization mode, map checkpoints
(``save_map``/``load_map``, ``slam/checkpoint.py``) and the stereo-inertial
path (``track_stereo_inertial``): per-frame IMU preintegration and
prediction, the per-frame VI state optimization (``optim/vio.py``),
inertial keyframes, IMU initialization, VI local BA, the inertial global
BA and the 4-DoF loop correction. The monocular paths (``track_mono``,
``track_mono_inertial``) initialize by two views (``ops/twoview.py``),
track with ``tracking.full_mono_step``, triangulate each keyframe against
its covisible neighbours, correct loops in Sim(3), and, with an IMU, solve
the metric scale at IMU initialization and re-gauge the map. ``track_rgbd``
takes a gray image and its metric depth map (uploaded with one
non-blocking copy from pinned memory) through ``tracking.full_rgbd_step``.
A KB8 camera with ``right_intrinsics`` and ``Tlr`` is a stereo-fisheye rig:
``track_stereo`` and ``track_stereo_inertial`` take its raw pairs through
``tracking.full_fisheye_step``, and every optimizer adds one right-camera
row per matched feature through ``rig`` = (R_rl, t_rl, params_r), built
once on the device.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.config import SLAMConfig, SensorType
from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
from orb_slam3_detailed_comments_kor_tpu_torch.ops import imu as imu_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching, ransac, twoview
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops.stereo import _nanmedian
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, vio
from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba, dist_vi_ba
from orb_slam3_detailed_comments_kor_tpu_torch.slam import checkpoint, frontend, inertial
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
    """Stereo, monocular, RGB-D and (stereo- or mono-) inertial SLAM system,
    pinhole or KB8 fisheye, over device-resident map state.

    ``device`` is where the map, the vocabulary and every per-frame tensor
    live: the card unless the caller names another. ``enable_loop_closing``
    is True by default, as in the reference.
    """

    #: frames whose decision scalars are fetched with one batched readback
    #: (default; overridden from ``TrackingConfig.decision_batch``)
    decision_batch = 4

    def __init__(self, config: SLAMConfig, device="cuda"):
        cam = config.camera
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
        # raw pinhole inputs with distortion: keypoints are undistorted at
        # extraction (Frame::UndistortKeyPoints, src/Frame.cc:733); stereo
        # pinhole inputs are taken as rectified
        self._dist = (tuple(float(v) for v in cam.dist)
                      if cam.model == "pinhole" and any(abs(v) > 0 for v in cam.dist) else None)
        # stereo fisheye: two KannalaBrandt8 cameras and their calibrated
        # extrinsic (Frame.cc:1021; TUM_512.yaml's Camera2.* and Tlr), and
        # the right-camera observation rig of the optimizers (ToBody edges,
        # include/OptimizableTypes.h:31-145): (R_rl, t_rl, params_r), made
        # once on the device
        self.stereo_fisheye = cam.model == "kannala_brandt8" and cam.right_intrinsics is not None
        self.rig = None
        if self.stereo_fisheye:
            self.cam_params_r = torch.tensor(cam.right_intrinsics, dtype=torch.float32).to(self.device)
            T = np.asarray(cam.tlr, np.float32).reshape(-1)
            M = torch.from_numpy(T.reshape(3, 4) if T.size == 12 else T.reshape(4, 4)[:3].copy()).to(self.device)
            # Tlr maps right-camera coordinates to the left; triangulation
            # takes the left-to-right transform
            self.R_rl, self.t_rl = lie.se3_inverse(M[:, :3], M[:, 3])
            self.rig = (self.R_rl, self.t_rl, self.cam_params_r)
        # the monocular initialization's held reference (frame, time)
        self._mono_ref = None
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
        # the mono step's always-present pose prior, with zero information
        # (no IMU prediction), made once
        self._zero_prior = (torch.eye(3, device=self.device), torch.zeros(3, device=self.device), 0.0, 0.0)
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
        # Atlas: shelved maps (relocalization can switch back to one, and
        # map_merging.try_merge welds the active map back into one)
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
        # localization mode, and its last tracked (frame, (R_cw, t_cw))
        self.localization_only = False
        self._loc_prev = None
        if config.is_inertial:
            self._init_inertial()

    def _init_inertial(self) -> None:
        """The inertial state (IMU_STEREO): per-keyframe VI block, the
        camera-from-body extrinsic, gravity, the IMU sample buffer, the
        per-frame preintegration segments and the VIO prior chain."""
        dev = self.device
        self.ikf = inertial.empty_inertial(self.cfg.capacity.max_keyframes, device=dev)
        tbc = torch.from_numpy(np.asarray(self.cfg.imu.tbc, np.float32).reshape(4, 4)).to(dev)
        # the config stores T_bc (camera to body); the optimizers take T_cb
        self.R_cb, self.t_cb = lie.se3_inverse(tbc[:3, :3], tbc[:3, 3])
        self.imu_initialized = False
        self.gravity = torch.tensor([0.0, 9.81, 0.0]).to(dev)  # re-estimated at init
        self._imu_buf: List[tuple] = []
        self._last_frame_time = None
        self._last_kf_time = None
        self.frame_vel = torch.zeros(3, device=dev)
        # incremental preintegration: one segment per frame plus a running
        # composition since the last keyframe
        self._pre_segments: List[tuple] = []
        self._pre_run = None
        self._seg_t = None
        # the per-frame VI estimator: the marginal prior carried between
        # frames and the last optimized frame state
        self._vio_prior = None
        self._vio_state = None
        self._vio_prior_t = None
        self._map_poses_dirty = True
        self._suppress_imu_pred = 0
        self._init_kf_count = 0
        self._gba_sweep_pos = None
        # consecutive monocular IMU initializations refused by the scale guard
        self._imu_init_failures = 0

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

    def camera_center(self) -> np.ndarray:
        """The live camera centre in the active map's world (a host read)."""
        R = self.R_cw.cpu().numpy()
        t = self.t_cw.cpu().numpy()
        return -R.T @ t

    # ------------------------------------------------------------------
    # Localization-only mode (System::ActivateLocalizationMode /
    # Tracking::InformOnlyTracking): tracking goes on against the frozen
    # map; no keyframes are inserted and no mapping or loop work runs.
    # ------------------------------------------------------------------
    def activate_localization_mode(self) -> None:
        self.flush_decisions()
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

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
        """Feed one stereo pair (arrays or tensors of [H, W] intensities):
        rectified pinhole, or a raw dual-fisheye pair when the camera is
        KB8 with Camera2 intrinsics and Tlr. Returns the tracking state."""
        cam = self.cfg.camera
        self.n_frames += 1
        self._check_timestamp_jump(t)
        img_l = self._upload(img_l)
        img_r = self._upload(img_r)
        if self.stereo_fisheye:
            if self.state == TrackingState.NOT_INITIALIZED:
                orb = self.cfg.orb
                frame = frontend.process_stereo_fisheye(
                    img_l, img_r, self.cam_params, self.cam_params_r, self.R_rl, self.t_rl,
                    n_features=orb.n_features, n_levels=orb.n_levels, scale=orb.scale_factor,
                    cell=orb.cell_size,
                )
                self._stereo_initialize(frame, t)
            else:
                self._track_fisheye_fused(img_l, img_r, t)
            self._record_frame(t)
            return self.state
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

    def _track(self, img_l, img_r, t: float, override_pred=None):
        """Deferred-decision tracking: the device step for each frame is
        dispatched immediately; the host-side branching (lost / keyframe
        decision) is resolved in batches of ``decision_batch`` frames with
        one double-buffered device-to-host read, so decisions lag the
        dispatch by up to 2 x ``decision_batch`` frames. ``override_pred``:
        an IMU-predicted (R_cw, t_cw), fed as the last pose with no
        velocity, so the step's search starts there."""
        cam = self.cfg.camera
        # the prediction's pose and velocity flag are taken before the
        # frame's background slice, as the reference takes them: a loop
        # correction in that slice re-bases the live pose for the NEXT frame
        if override_pred is not None:
            (R_last, t_last), has_vel = override_pred, self._vel_flag[False]
        else:
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

    def _pose_prior(self, R_last, t_last, override_pred):
        """The mono and fisheye steps' always-present pose prior: the
        IMU-predicted pose at the configured information when the prediction
        comes from the IMU, else zero information."""
        if override_pred is not None and self.cfg.is_inertial:
            tc = self.cfg.tracking
            return (R_last, t_last, 1.0 / tc.imu_prior_sigma_rot ** 2, 1.0 / tc.imu_prior_sigma_trans ** 2)
        return self._zero_prior

    def _track_fisheye_fused(self, img_l, img_r, t: float, override_pred=None):
        """Deferred-decision dual-fisheye tracking: the stereo ``_track``
        pipeline through ``tracking.full_fisheye_step`` (the KB8 model and
        the rig rows); an IMU-predicted ``override_pred`` also enters the
        pose solve as a prior."""
        cam, orb = self.cfg.camera, self.cfg.orb
        if override_pred is not None:
            (R_last, t_last), has_vel = override_pred, self._vel_flag[False]
        else:
            R_last, t_last, has_vel = self.R_cw, self.t_cw, self._vel_flag[self.has_velocity]
        prior = self._pose_prior(R_last, t_last, override_pred)
        self._service_background()
        with self.timer.span("track/dispatch"):
            out = tracking.full_fisheye_step(
                self.ms, img_l, img_r, R_last, t_last, self.vel_R, self.vel_t, has_vel,
                self.cam_params, self.cam_params_r, self.R_rl, self.t_rl, prior,
                w=cam.width, h=cam.height, scale=orb.scale_factor, n_levels=orb.n_levels,
                n_features=orb.n_features, cell=orb.cell_size,
                min_inliers=self.cfg.tracking.min_inliers_local_map, far_dist=cam.th_far_points,
            )
        self._after_dispatch(out, t)
        return out

    def _upload(self, x):
        """A host array as a float32 tensor on the system's device: one
        non-blocking copy from pinned memory on the card (a pageable copy
        would wait for the stream); tensors are moved as they are. Every
        ``track_*`` entry point takes its images and depth maps through
        it."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        host = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # RGB-D mode (System::TrackRGBD)
    # ------------------------------------------------------------------
    def track_rgbd(self, img, depth_map, t: float) -> int:
        """Feed one RGB-D frame: a gray image [H, W] and its metric depth
        [H, W] (arrays or tensors). Returns the tracking state."""
        self.n_frames += 1
        self._check_timestamp_jump(t)
        img, depth_map = self._upload(img), self._upload(depth_map)
        if self.state == TrackingState.NOT_INITIALIZED:
            orb = self.cfg.orb
            frame = frontend.process_rgbd(
                img, depth_map, self.cfg.camera.bf, n_features=orb.n_features, n_levels=orb.n_levels,
                scale=orb.scale_factor, cell=orb.cell_size, dist=self._dist, cam_params=self.cam_params,
            )
            self._stereo_initialize(frame, t)
        else:
            self._track_rgbd_fused(img, depth_map, t)
        self._record_frame(t)
        return self.state

    def _track_rgbd_fused(self, img, depth_map, t: float):
        """Deferred-decision RGB-D tracking through
        ``tracking.full_rgbd_step``."""
        cam, orb = self.cfg.camera, self.cfg.orb
        R_last, t_last, has_vel = self.R_cw, self.t_cw, self._vel_flag[self.has_velocity]
        self._service_background()
        with self.timer.span("track/dispatch"):
            out = tracking.full_rgbd_step(
                self.ms, img, depth_map, R_last, t_last, self.vel_R, self.vel_t, has_vel,
                self.cam_params, bf=cam.bf, w=cam.width, h=cam.height, scale=orb.scale_factor,
                n_levels=orb.n_levels, n_features=orb.n_features, cell=orb.cell_size,
                min_inliers=self.cfg.tracking.min_inliers_local_map, far_dist=cam.th_far_points,
                dist=self._dist,
            )
        self._after_dispatch(out, t)
        return out

    # ------------------------------------------------------------------
    # Monocular mode (System::TrackMonocular)
    # ------------------------------------------------------------------
    def track_mono(self, img, t: float) -> int:
        """Feed one grayscale frame (an array or tensor of [H, W]
        intensities). The map's scale is arbitrary: the two-view baseline
        is set so that the median scene depth is 2. Returns the tracking
        state."""
        self.n_frames += 1
        self._check_timestamp_jump(t)
        img = self._upload(img)
        if self.state == TrackingState.NOT_INITIALIZED:
            orb = self.cfg.orb
            frame = frontend.process_mono(
                img, n_features=orb.n_features, n_levels=orb.n_levels, scale=orb.scale_factor,
                cell=orb.cell_size, dist=self._dist, cam_params=self.cam_params,
            )
            self._mono_initialize(frame, t)
        else:
            self._track_mono_fused(img, t)
        self._record_frame(t)
        return self.state

    def _mono_initialize(self, frame: frontend.Frame, t: float) -> None:
        """MonocularInitialization (``Tracking.cc:2373``): hold a reference
        frame, match a later frame against it in a 100 px window, run the
        two-view reconstruction and spawn the initial map (two keyframes,
        the triangulated points, a 10-iteration BA). Host reads: the
        feature count, the match count, the reconstruction's verdict and
        its point count, as in the reference."""
        n_feat = int(frame.valid.sum())
        if self._mono_ref is None:
            if n_feat > 100:
                self._mono_ref = (frame, t)
            return
        ref, t_ref = self._mono_ref
        if n_feat <= 100:
            self._mono_ref = None
            return
        # windowed matching (SearchForInitialization)
        d2 = torch.sum((ref.xy[:, None, :] - frame.xy[None, :, :]) ** 2, dim=-1)
        res = matching.match_nn_ratio(ref.desc, frame.desc, ref.valid, frame.valid,
                                      max_dist=50, ratio=0.9, mask=d2 < 100.0 ** 2)
        if int(res.valid.sum()) < 100:
            # a stale reference is replaced (after 1 s, as the reference)
            if t - t_ref > 1.0:
                self._mono_ref = (frame, t)
            return
        rays_a = cam_mod.unproject(self.cam_params, ref.xy, self.cam_model)
        rays_b = cam_mod.unproject(self.cam_params, frame.xy[torch.clamp(res.idx, min=0).to(torch.int64)],
                                   self.cam_model)
        tv = twoview.reconstruct_two_views_hf(rays_a, rays_b, res.valid, self._split_key(), n_hyp=256,
                                              inlier_th=(1.5 / self.cfg.camera.fx) ** 2)
        if not bool(tv.ok):
            return
        # gauge: the median triangulated depth becomes 2
        med = torch.nan_to_num(_nanmedian(torch.where(tv.inlier, tv.X[:, 2], float("nan"))), nan=1.0)
        s = 2.0 / torch.clamp(med, min=1e-3)
        X_w = tv.X * s  # the reference frame is the world frame
        # both keyframes (no landmarks yet), then the triangulated set
        self.R_cw, self.t_cw = torch.eye(3, device=self.device), torch.zeros(3, device=self.device)
        self._insert_keyframe_visual_only(ref, t_ref, None)
        self.R_cw, self.t_cw = tv.R_ba, tv.t_ba * s
        self._insert_keyframe_visual_only(frame, t, None)
        orb = self.cfg.orb
        self.ms = tracking.add_triangulated_landmarks(
            self.ms, 0, 1, torch.where(tv.inlier, res.idx, -1), X_w, tv.inlier, self.cam_params,
            scale=orb.scale_factor, n_levels=orb.n_levels,
        )
        self.ms = tracking.local_ba_step(
            self.ms, 1, self.cam_params, self.cfg.camera.bf, window=2,
            lm_cap=self.cfg.capacity.max_local_landmarks, iters=10, cam_model=self.cam_model,
        )
        self.state = TrackingState.OK
        self.inliers_at_last_kf = int(tv.n_good)
        self._mono_ref = None

    def _track_mono_fused(self, img, t: float, override_pred=None):
        """Deferred-decision monocular tracking: the stereo ``_track``
        pipeline through ``full_mono_step``; an IMU-predicted
        ``override_pred`` also enters the pose solve as a prior."""
        cam = self.cfg.camera
        if override_pred is not None:
            (R_last, t_last), has_vel = override_pred, self._vel_flag[False]
        else:
            R_last, t_last, has_vel = self.R_cw, self.t_cw, self._vel_flag[self.has_velocity]
        prior = self._pose_prior(R_last, t_last, override_pred)
        self._service_background()
        orb = self.cfg.orb
        with self.timer.span("track/dispatch"):
            out = tracking.full_mono_step(
                self.ms, img, R_last, t_last, self.vel_R, self.vel_t, has_vel, self.cam_params, prior,
                bf=cam.bf, w=cam.width, h=cam.height, scale=orb.scale_factor, n_levels=orb.n_levels,
                n_features=orb.n_features, cell=orb.cell_size,
                min_inliers=self.cfg.tracking.min_inliers_local_map, far_dist=cam.th_far_points,
                cam_model=self.cam_model, dist=self._dist,
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
        if self.localization_only:
            # the last tracked frame and its pose: the temporal-VO fallback
            # lifts points through it (Tracking.cc:2750)
            self._loc_prev = (frame, (tr.R_cw, tr.t_cw))
        gap = dispatch_idx - self._last_kf_dispatch_idx if dispatch_idx is not None else None
        if self._need_new_keyframe(frame, n_inliers, gap):
            # the keyframe is inserted with ITS OWN tracked pose; the live
            # pose is restored relatively (T_live ∘ T_kf⁻¹ re-applied)
            R_rel, t_rel = lie.se3_rel(self.R_cw, self.t_cw, tr.R_cw, tr.t_cw)
            self.R_cw, self.t_cw = tr.R_cw, tr.t_cw
            self._cur_track_inliers = n_inliers
            with self.timer.span("mapping/insert_kf"):
                if self.cfg.is_inertial and self.n_kf > 0:
                    self._insert_keyframe_inertial(frame, t, lm_feat=tr.lm_feat)
                else:
                    self._insert_keyframe(frame, t, lm_feat=tr.lm_feat)
            self.R_cw, self.t_cw = lie.se3_compose_j(R_rel, t_rel, self.R_cw, self.t_cw)
            self.inliers_at_last_kf = n_inliers
            if dispatch_idx is not None:
                self._last_kf_dispatch_idx = dispatch_idx

    # ------------------------------------------------------------------
    # Lost path and Atlas elasticity (Tracking::CreateMapInAtlas /
    # ResetActiveMap)
    # ------------------------------------------------------------------
    def _loc_vo_fallback(self, frame) -> bool:
        """Localization-mode temporal VO (``Tracking.cc:2750``
        ``UpdateLastFrame``): match the frame to the last tracked frame,
        lift the matches through its stereo depth at its optimized pose, and
        run motion-only pose optimization on those points. Nothing enters
        the map. Returns True when the frame was recovered; two host reads
        (whether the last frame has depth, the inlier count)."""
        if self._loc_prev is None or not self.localization_only:
            return False
        prev, (R_p, t_p) = self._loc_prev
        depth_ok = prev.depth > 0
        if not bool(depth_ok.any()):
            return False
        res = matching.match_nn_ratio(frame.desc, prev.desc, frame.valid, prev.valid & depth_ok,
                                      max_dist=60, ratio=0.85)
        feat_b = torch.clamp(res.idx, min=0).to(torch.int64)
        z = prev.depth[feat_b]
        rays = cam_mod.unproject(self.cam_params, prev.xy[feat_b], self.cam_model)
        Xw = (rays * z[:, None] - t_p) @ R_p  # R_pᵀ(Xc − t_p)
        valid = res.valid & (z > 0.05)
        # op by op, as the reference dispatches it eagerly: a true division
        inv_s2 = 1.0 / (self.cfg.orb.scale_factor ** (2.0 * frame.level.to(torch.float32)))
        opt = ba.pose_optimization(R_p, t_p, Xw, frame.xy, frame.u_right, inv_s2, valid,
                                   self.cam_params, self.cfg.camera.bf, cam_model=self.cam_model)
        if int(opt.n_inliers) < max(20, self.cfg.tracking.min_inliers_local_map):
            return False
        self.R_cw, self.t_cw = opt.R_cw, opt.t_cw
        Ri, ti = lie.se3_inverse(R_p, t_p)
        self.vel_R, self.vel_t = lie.se3_compose(opt.R_cw, opt.t_cw, Ri, ti)
        self.has_velocity = True
        self._loc_prev = (frame, (opt.R_cw, opt.t_cw))
        return True

    def _handle_lost(self, frame) -> None:
        """Localization-mode VO, else relocalize, else degrade; on hard loss
        either reset a young map or shelve a mature one and start fresh
        (``Tracking.cc:1930-1948``)."""
        if self._loc_vo_fallback(frame):
            self.n_lost_frames = 0
            self.state = TrackingState.OK
            return
        if self._relocalize(frame):
            self.n_lost_frames = 0
            self.state = TrackingState.OK
            return
        self.n_lost_frames += 1
        # with an initialized IMU the tracker coasts on dead-reckoned
        # predictions for time_recently_lost seconds (Tracking.cc:1904-1917);
        # without one the prediction decays fast: ~1 s of attempts
        budget = 20
        if self.cfg.is_inertial and self.imu_initialized:
            budget = max(20, int(round(self.cfg.tracking.time_recently_lost * max(self.cfg.camera.fps, 1.0))))
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
        map's BoW database (relocalization and merge detection search it)
        and the merge prior: the next map's world frame is about this
        camera frame at the loss, so a later merge transform should stay
        near T_cw_loss⁻¹ up to the drift since the split
        (``map_merging._merge_gate_allows``). One host read (the pose)."""
        # complete pending BoW inserts so the shelved database covers every
        # keyframe; refinement slices are dropped with the queue on reset
        for kind, fn in list(self._bg_queue):
            if kind == "bow_insert":
                fn()
        pose = torch.cat([self.R_cw.reshape(-1), self.t_cw]).cpu().numpy()
        self.atlas_maps.append(self._inertial_shelf({
            "ms": self.ms,
            "n_kf": self.n_kf,
            "loop_closer": self.loop_closer,
            "traj_end": len(self.trajectory),
            "gen": self._map_gen,
            "kf_times": list(self._host_kf_times()),
            "kf_lowq": list(self._kf_lowq_host),
            # (R_cw, t_cw at the loss, its time, seconds spent coasting
            # blind before it), numpy float32 as the reference keeps them
            "merge_prior": (pose[:9].reshape(3, 3), pose[9:], float(self._last_track_time or 0.0),
                            float(self.n_lost_frames / max(self.cfg.camera.fps, 1.0))),
        }))
        self._reset_active_map()

    def _inertial_shelf(self, shelf: dict) -> dict:
        """Inertial maps keep their VI state on the shelf, so that a later
        merge (MergeLocal2) can weld the inertial chains and adopt the old
        map's gravity frame."""
        if self.cfg.is_inertial:
            shelf.update(ikf=self.ikf, gravity=self.gravity, imu_initialized=self.imu_initialized)
        return shelf

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
        if self.cfg.is_inertial:
            self.ikf = inertial.empty_inertial(cap.max_keyframes, device=self.device)
            self.imu_initialized = False
            self._imu_buf.clear()
            self._last_kf_time = None
            self._reset_pre_segments()
        # a new map initializes by two views again
        self._mono_ref = None

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
        uv_obs = frame.xy
        if self.cam_model != "pinhole":
            # bearing-space PnP (MLPnP works on bearing vectors,
            # src/MLPnPsolver.cpp): fisheye pixels become rays, expressed as
            # measurements of a virtual pinhole with the same intrinsics
            rays = cam_mod.unproject(self.cam_params, frame.xy, self.cam_model)
            p = self.cam_params
            uv_obs = torch.stack([p[0] * rays[:, 0] + p[2], p[1] * rays[:, 1] + p[3]], dim=-1)
        R, t, _, n = ransac.pnp_ransac(X, uv_obs, ok3d, self.cam_params, self._split_key(),
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
            self.atlas_maps.append(self._inertial_shelf({
                "ms": self.ms,
                "n_kf": self.n_kf,
                "loop_closer": self.loop_closer,
                "traj_end": len(self.trajectory),
                "gen": self._map_gen,
                "kf_times": list(self._host_kf_times()),
                "kf_lowq": list(self._kf_lowq_host),
            }))
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
        if self.cfg.is_inertial and "ikf" in shelf:
            self.ikf = shelf["ikf"]
            self.gravity = shelf["gravity"]
            self.imu_initialized = shelf["imu_initialized"]
            self._imu_buf.clear()
            self._last_kf_time = self._last_track_time
            self._reset_pre_segments()
            # the shelved map's last keyframe velocity is stale: the visual
            # motion model re-seeds tracking for two frames before the IMU
            # prediction is trusted again
            self._suppress_imu_pred = 2

    # ------------------------------------------------------------------
    # Background mapping FIFO: every per-keyframe job (duplicate fusion,
    # local-BA slices, culling) is a bounded device slice, one serviced
    # ahead of each subsequent frame dispatch.
    # ------------------------------------------------------------------
    def _bg_push(self, kind: str, fn) -> None:
        self._bg_queue.append((kind, fn))

    def _bg_drop(self, kinds) -> None:
        self._bg_queue = [(k, f) for (k, f) in self._bg_queue if k not in kinds]

    #: slice kinds that rewrite keyframe poses or velocities: servicing one
    #: restarts the per-frame VIO prior chain (``mbMapUpdated``,
    #: ``Tracking.cc:1806-1815``)
    _POSE_REWRITE_KINDS = frozenset(("local_ba_chunk", "cull_kf", "loop", "try_merge", "init_fiba"))

    def _run_slice(self, kind: str, fn) -> None:
        with self.timer.span(f"mapping/{kind}"):
            fn()
        if kind in self._POSE_REWRITE_KINDS:
            self._map_poses_dirty = True

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
        if self.cfg.is_inertial and self.imu_initialized:
            self.ms, self.ikf, _ = inertial.local_vi_ba_step(
                self.ms, self.ikf, kf_idx, self.gravity, self.cam_params, self.R_cb, self.t_cb,
                cam.bf, window=10, lm_cap=self.cfg.capacity.max_local_landmarks,
                iters=2, cam_model=self.cam_model, rig=self.rig,
            )
            return
        self.ms = tracking.local_ba_step(
            self.ms, kf_idx, self.cam_params,
            cam.bf, window=min(8, self.cfg.capacity.max_local_kfs),
            lm_cap=self.cfg.capacity.max_local_landmarks,
            iters=2, cam_model=self.cam_model, rig=self.rig,
        )

    #: queued-slice backpressure: past this depth the inserting keyframe
    #: services slices inline until the queue fits
    _BG_QUEUE_MAX = 8

    def _bg_backpressure(self) -> None:
        while len(self._bg_queue) > self._BG_QUEUE_MAX:
            self._run_slice(*self._bg_queue.pop(0))

    def _service_background(self) -> None:
        """One background slice per frame dispatch: queued per-KF mapping
        jobs first, then any pending GBA slice."""
        if self._bg_queue:
            self._run_slice(*self._bg_queue.pop(0))
        else:
            self._service_gba()

    def _service_gba(self) -> None:
        """Dispatch one pending GBA slice (2 LM iterations over the whole
        map) and adapt the remaining budget to its cost. Inertial maps take
        FullInertialBA slices (``LoopClosing.cc:2287-2289``): on a mesh of
        more than one shard the observation-sharded whole-map solve
        (``dist_vi_ba``, cost None) at any keyframe count; else up to 128
        keyframe slots a sweep of the init-FIBA window program (window
        slices; their costs are local and feed no budget), above that the
        whole-map PCG solve."""
        if self._gba_chunks_left > 0:
            with self.timer.span("mapping/gba_chunk"):
                if self.cfg.is_inertial and self.imu_initialized:
                    cost = self._inertial_gba_slice()
                else:
                    self.ms, cost = self.loop_closer.gba_chunk(
                        self.ms, self.cam_params, self.cfg.camera.bf, cam_model=self.cam_model, rig=self.rig,
                    )
            self._gba_chunks_left -= 1
            self._gba_chunks_run += 1
            if self.cfg.is_inertial:
                self._map_poses_dirty = True
            self._adapt_gba_budget(cost)

    def _inertial_gba_slice(self):
        cam = self.cfg.camera
        if len(dist_ba.resolve_mesh(dist_vi_ba._VI_GBA_MESH, self.device)) > 1:
            self.ms, self.ikf, cost = dist_vi_ba.distributed_full_inertial_ba(
                self.ms, self.ikf, self.gravity, self.cam_params, self.R_cb, self.t_cb, cam.bf,
                iters=2, cam_model=self.cam_model, rig=self.rig,
            )
            return cost
        if self.ms.K <= 128:
            W = self._INIT_FIBA_WINDOW
            n1 = self.n_kf - 1
            cur = self._gba_sweep_pos
            cur = min(W - 1, n1) if cur is None or cur >= n1 else min(cur + W, n1)
            self._gba_sweep_pos = cur
            self.ms, self.ikf, _ = inertial.local_vi_ba_step(
                self.ms, self.ikf, cur, self.gravity, self.cam_params, self.R_cb, self.t_cb,
                cam.bf, window=W, lm_cap=self.cfg.capacity.max_local_landmarks,
                iters=2, cam_model=self.cam_model, rig=self.rig,
            )
            return None
        self.ms, self.ikf, cost = inertial.full_inertial_ba(
            self.ms, self.ikf, self.gravity, self.cam_params, self.R_cb, self.t_cb, cam.bf,
            iters=2, cam_model=self.cam_model, rig=self.rig,
        )
        return cost

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

    def _track_with_frame(self, frame: frontend.Frame, t: float, override_pred=None) -> None:
        """Unfused, synchronous track path for pre-extracted frames (the
        replay of stale decisions after a map switch). With an IMU-predicted
        ``override_pred`` (R_cw, t_cw) the prediction also enters the pose
        solve as a prior (``Optimizer.cc:6697``)."""
        cam = self.cfg.camera
        self._service_background()
        if self.has_velocity:
            R_pred, t_pred = lie.se3_compose(self.vel_R, self.vel_t, self.R_cw, self.t_cw)
        else:
            R_pred, t_pred = self.R_cw, self.t_cw
        prior = None
        if override_pred is not None:
            R_pred, t_pred = override_pred
            if self.cfg.is_inertial:
                tc = self.cfg.tracking
                prior = (R_pred, t_pred, 1.0 / tc.imu_prior_sigma_rot ** 2, 1.0 / tc.imu_prior_sigma_trans ** 2)
        tr = tracking.track_frame(
            self.ms, frame, R_pred, t_pred, self.cam_params, cam.bf,
            w=cam.width, h=cam.height,
            scale=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            prior=prior, cam_model=self.cam_model, far_dist=self.cfg.camera.th_far_points,
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
            if self.cfg.is_inertial and self.n_kf > 0:
                self._insert_keyframe_inertial(frame, t, lm_feat=tr.lm_feat)
            else:
                self._insert_keyframe(frame, t, lm_feat=tr.lm_feat)
            self.inliers_at_last_kf = n_inliers

    # ------------------------------------------------------------------
    # Stereo-inertial mode (System::TrackStereo with IMU measurements)
    # ------------------------------------------------------------------
    def grab_imu(self, t: float, acc, gyro) -> None:
        """Queue one IMU sample (``Tracking::GrabImuData``, ``Tracking.cc:1445``)."""
        self._imu_buf.append((t, np.asarray(acc), np.asarray(gyro)))

    def _upload_batch(self, samples, start, cap: int) -> imu_ops.ImuBatch:
        """One packed host-to-device copy of a sample window ([cap, 8]: acc,
        gyro, dt, valid), from pinned memory without waiting on the stream
        when the system lives on the card."""
        pk = np.zeros((cap, 8), np.float32)
        prev = start
        for i, (ts, a, g) in enumerate(samples[:cap]):
            pk[i, 0:3] = a
            pk[i, 3:6] = g
            pk[i, 6] = max(ts - prev, 0.0) if prev is not None else 0.0
            pk[i, 7] = 1.0
            prev = ts
        host = torch.from_numpy(pk)
        if self.device.type == "cuda":
            host = host.pin_memory()
        pkd = host.to(self.device, non_blocking=True)
        return imu_ops.ImuBatch(acc=pkd[:, 0:3], gyro=pkd[:, 3:6], dt=pkd[:, 6], valid=pkd[:, 7] > 0.5)

    def _imu_sigmas(self):
        imu_cfg = self.cfg.imu
        return (float(imu_cfg.noise_gyro * np.sqrt(imu_cfg.frequency)),
                float(imu_cfg.noise_acc * np.sqrt(imu_cfg.frequency)))

    def _preintegrate_since_last_kf(self, t_end: float = None):
        """Integrate the queued samples after the last keyframe (up to
        ``t_end``) at the current bias estimate."""
        cap = self.cfg.capacity.max_imu_per_frame * max(self.cfg.tracking.max_frames_between_kf, 1)
        buf = self._imu_buf
        if t_end is not None:
            buf = [s for s in buf if s[0] <= t_end]
        if self._last_kf_time is not None:
            # samples at or before the window start belong to earlier windows
            buf = [s for s in buf if s[0] > self._last_kf_time]
        batch = self._upload_batch(buf, self._last_kf_time, cap)
        kf_idx = max(self.n_kf - 1, 0)
        return imu_ops.integrate(batch, self.ikf.bg[kf_idx], self.ikf.ba[kf_idx], *self._imu_sigmas())

    def _reset_pre_segments(self) -> None:
        self._pre_segments = []
        self._pre_run = None
        self._seg_t = self._last_kf_time
        # the VIO prior chain is anchored to the dropped window
        self._vio_prior = None
        self._vio_state = None
        self._map_poses_dirty = True

    def _frame_sample_batch(self, t: float):
        """This frame's IMU samples as a padded ImuBatch, or None before the
        first keyframe window opens."""
        if self._last_kf_time is None:
            return None
        if self._seg_t is None:
            self._seg_t = self._last_kf_time
        start = self._seg_t
        buf = [s for s in self._imu_buf if start < s[0] <= t]
        return self._upload_batch(buf, start, self.cfg.capacity.max_imu_per_frame)

    def _integrate_new_samples(self, t: float) -> None:
        """Integrate this frame's samples into one cached segment and fold
        it into the running window (``IntegrateNewMeasurement``)."""
        batch = self._frame_sample_batch(t)
        if batch is None:
            return
        kf_idx = max(self.n_kf - 1, 0)
        pre = imu_ops.integrate(batch, self.ikf.bg[kf_idx], self.ikf.ba[kf_idx], *self._imu_sigmas())
        self._pre_segments.append((t, pre))
        self._pre_run = pre if self._pre_run is None else imu_ops.compose(self._pre_run, pre)
        self._seg_t = t

    def _advance_imu(self, t: float):
        """The per-frame IMU pipeline (``inertial.advance_imu``): integrate,
        compose, predict. Returns (R_pred, t_pred, v_pred) or None (before
        init, suppressed or no window)."""
        want_pred = self.imu_initialized and self._suppress_imu_pred <= 0 and self._last_kf_time is not None
        if not want_pred:
            self._integrate_new_samples(t)
            return self._imu_predicted_pose()
        batch = self._frame_sample_batch(t)
        if batch is None:
            return self._imu_predicted_pose()
        kf_idx = max(self.n_kf - 1, 0)
        bg, ba_ = self.ikf.bg[kf_idx], self.ikf.ba[kf_idx]
        pre_run = (self._pre_run if self._pre_run is not None
                   else imu_ops.identity_preintegrated(self.device)._replace(bias_g=bg, bias_a=ba_))
        with self.timer.span("track/imu"):
            seg, run, R_pred, t_pred, v2 = inertial.advance_imu(
                batch, bg, ba_, *self._imu_sigmas(), pre_run, self.ms.kf_R_cw[kf_idx],
                self.ms.kf_t_cw[kf_idx], self.ikf.vel[kf_idx], self.gravity, self.R_cb, self.t_cb,
            )
        self._pre_segments.append((t, seg))
        self._pre_run = run
        self._seg_t = t
        return R_pred, t_pred, v2

    def _window_pre_consume(self, t_end: float):
        """Compose the cached segments covering (last_kf_time, t_end] and
        drop them (keyframe insertion consumes its window); the rest re-form
        the running window. Re-integrates the raw buffer when the cache does
        not cover the span."""
        eps = 1e-9
        consumed = [p for (ts, p) in self._pre_segments if ts <= t_end + eps]
        rest = [(ts, p) for (ts, p) in self._pre_segments if ts > t_end + eps]
        if not consumed or self._last_kf_time is None:
            self._reset_pre_segments()
            return self._preintegrate_since_last_kf(t_end=t_end)
        total = consumed[0]
        for p in consumed[1:]:
            total = imu_ops.compose(total, p)
        self._pre_segments = rest
        self._pre_run = None
        if rest:
            run = rest[0][1]
            for _, p in rest[1:]:
                run = imu_ops.compose(run, p)
            self._pre_run = run
        self._seg_t = rest[-1][0] if rest else t_end
        return total

    def track_stereo_inertial(self, img_l, img_r, t: float, imu_samples=None) -> int:
        """Feed a rectified stereo pair and the IMU samples since the
        previous frame (an iterable of (t, acc[3], gyro[3])). Returns the
        tracking state."""
        if not self.cfg.is_inertial:
            raise ValueError("track_stereo_inertial needs an IMU_STEREO configuration")
        for smp in imu_samples or []:
            self.grab_imu(*smp)
        self._check_timestamp_jump(t)
        if self.state == TrackingState.NOT_INITIALIZED:
            st = self.track_stereo(img_l, img_r, t)
            if self.state == TrackingState.OK:  # the first keyframe was made
                self._last_kf_time = t
                self._imu_buf.clear()
                self._reset_pre_segments()
            self._last_frame_time = t
            return st
        pred = self._advance_imu(t)
        img_l = self._upload(img_l)
        img_r = self._upload(img_r)
        track = self._track_fisheye_fused if self.stereo_fisheye else self._track
        if pred is not None:
            R_pred, t_pred, v2 = pred
            out = track(img_l, img_r, t, override_pred=(R_pred, t_pred))
            self.frame_vel = v2
            self._vio_refine(out, t)
        else:
            track(img_l, img_r, t)
        self.n_frames += 1
        self._last_frame_time = t
        self._record_frame(t)
        return self.state

    def track_mono_inertial(self, img, t: float, imu_samples=None) -> int:
        """Feed one grayscale frame and the IMU samples since the previous
        frame (an iterable of (t, acc[3], gyro[3])). Returns the tracking
        state."""
        if self.cfg.sensor != SensorType.IMU_MONOCULAR:
            raise ValueError("track_mono_inertial needs an IMU_MONOCULAR configuration")
        for smp in imu_samples or []:
            self.grab_imu(*smp)
        self._check_timestamp_jump(t)
        if self.state == TrackingState.NOT_INITIALIZED:
            st = self.track_mono(img, t)
            if self.state == TrackingState.OK:
                # the two-view initialization made keyframe 0 (at the held
                # frame's time, as the map stores it in float32) and
                # keyframe 1 (now): keyframe 1 gets the 0 -> 1 window
                self._last_kf_time = float(np.float32(self._kf_times_host[0]))
                pre = self._preintegrate_since_last_kf(t_end=t)
                self.ikf = inertial.store_preintegration(self.ikf, 1, pre, torch.zeros(3, device=self.device))
                self._imu_buf = [smp for smp in self._imu_buf if smp[0] > t]
                self._last_kf_time = t
                self._reset_pre_segments()
            self._last_frame_time = t
            return st
        self.n_frames += 1
        pred = self._advance_imu(t)
        img = self._upload(img)
        if pred is not None:
            R_pred, t_pred, v2 = pred
            out = self._track_mono_fused(img, t, override_pred=(R_pred, t_pred))
            self.frame_vel = v2
            self._vio_refine(out, t)
        else:
            self._track_mono_fused(img, t)
        self._last_frame_time = t
        self._record_frame(t)
        return self.state

    def _imu_predicted_pose(self):
        """PredictStateIMU (``Tracking.cc:1561``): the camera pose
        dead-reckoned from the last keyframe's VI state through the queued
        window. Returns (R_pred, t_pred, velocity) or None before init."""
        if not self.imu_initialized:
            return None
        if self._suppress_imu_pred > 0:
            self._suppress_imu_pred -= 1
            return None
        if self._last_kf_time is None:
            return None
        pre = self._pre_run if self._pre_run is not None else self._preintegrate_since_last_kf()
        kf_idx = self.n_kf - 1
        return inertial.predict_from_pre(
            pre, self.ms.kf_R_cw[kf_idx], self.ms.kf_t_cw[kf_idx], self.ikf.vel[kf_idx],
            self.ikf.bg[kf_idx], self.ikf.ba[kf_idx], self.gravity, self.R_cb, self.t_cb,
        )

    def _vio_refine(self, out, t: float) -> None:
        """The per-frame VI state optimization with its marginal prior
        chain (``PoseInertialOptimizationLastKeyFrame``/``LastFrame``),
        chained on the frame step without a host read. After a keyframe
        insertion or a slice that rewrote map poses the chain restarts from
        the last keyframe's VI state with the window since it; otherwise it
        continues frame to frame with the frame's own segment."""
        if not self.cfg.tracking.use_frame_vio or out is None or not self.imu_initialized:
            return
        ms, frame, tr = out[0], out[1], out[2]
        seg = None
        if self._pre_segments and abs(self._pre_segments[-1][0] - t) < 1e-9:
            seg = self._pre_segments[-1][1]
        if (self._vio_prior is None or self._map_poses_dirty or seg is None
                # the chain prior must belong to the immediately previous frame
                or self._last_frame_time != self._vio_prior_t):
            # LastKeyFrame variant: the keyframe's current state, the window
            pre = self._pre_run
            if pre is None:
                return
            kf = self.n_kf - 1
            prior = vio.kf_prior(self.ms.kf_R_cw[kf], self.ms.kf_t_cw[kf], self.ikf.vel[kf],
                                 self.ikf.bg[kf], self.ikf.ba[kf], self.R_cb, self.t_cb)
            self._map_poses_dirty = False
        else:
            # LastFrame variant: the marginal prior chain and this segment
            prior, pre = self._vio_prior, seg
        with self.timer.span("track/vio"):
            R_cw, t_cw, cur, nxt, _ = vio.vio_frame_step(
                ms.lm_pos, tr.lm_feat, tr.lm_inlier, frame.xy, frame.u_right, frame.level, frame.uv_r,
                tr.R_cw, tr.t_cw, prior, pre, self.cam_params, self.R_cb, self.t_cb, self.gravity,
                self.rig, bf=self.cfg.camera.bf, scale=self.cfg.orb.scale_factor, cam_model=self.cam_model,
                min_inliers=self.cfg.tracking.min_inliers_local_map,
            )
        self.R_cw, self.t_cw = R_cw, t_cw
        self.frame_vel = cur.v
        self._vio_state = cur
        self._vio_prior = nxt
        self._vio_prior_t = t
        # the queued decision entry carries the refined pose, so that a
        # keyframe decided from it is inserted there (in degraded states the
        # entry was already consumed)
        q = self._pending_decisions
        if q and q[-1][0] is frame:
            f, tr0, tq, di, gen = q[-1]
            q[-1] = (f, tr0._replace(R_cw=R_cw, t_cw=t_cw), tq, di, gen)

    def _insert_keyframe_inertial(self, frame, t: float, lm_feat) -> None:
        """Keyframe insertion with its preintegration window, then IMU
        initialization (pre-init: the visual local BA inline) or the VI
        local-BA slices, the VIBA1/VIBA2 re-initializations and loop
        detection."""
        pre = self._window_pre_consume(t)
        kf_idx = self.n_kf  # the slot the keyframe will get
        self._insert_keyframe_visual_only(frame, t, lm_feat)
        # velocity: the prediction once initialized, else zero
        vel = self.frame_vel if self.imu_initialized else torch.zeros(3, device=self.device)
        self.ikf = inertial.store_preintegration(self.ikf, kf_idx, pre, vel)
        # carry the bias forward: the per-frame VIO estimate when fresh (the
        # keyframe inherits the frame's bias, Tracking.cc:3275), else the
        # previous keyframe's
        if kf_idx > 0:
            vs = self._vio_state
            fresh = self.imu_initialized and vs is not None
            self.ikf = self.ikf._replace(
                bg=inertial._set_row(self.ikf.bg, kf_idx, vs.bg if fresh else self.ikf.bg[kf_idx - 1]),
                ba=inertial._set_row(self.ikf.ba, kf_idx, vs.ba if fresh else self.ikf.ba[kf_idx - 1]),
            )
        # the VIO chain restarts from this keyframe
        self._map_poses_dirty = True
        # samples newer than this keyframe belong to the next window
        self._imu_buf = [smp for smp in self._imu_buf if smp[0] > t]
        self._last_kf_time = t

        cam = self.cfg.camera
        is_mono = self.cfg.sensor == SensorType.IMU_MONOCULAR
        if is_mono and self.n_kf >= 3:
            self._triangulate_new_points(kf_idx)
        if self.n_kf >= 3:
            self._bg_push("fuse", functools.partial(self._fuse_new_duplicates, kf_idx))
        if not self.imu_initialized:
            kt = self._host_kf_times()
            span = float(kt[self.n_kf - 1] - kt[0])
            # monocular scale needs a longer baseline to be observable
            # (1 s stereo / 2 s mono, LocalMapping.cc:1574-1607)
            if self.n_kf >= 8 and span >= (2.0 if is_mono else 1.0):
                with self.timer.span("mapping/imu_init"):
                    ikf2, g2, s = inertial.initialize_imu(
                        self.ms, self.ikf, self.n_kf, self.gravity, self.R_cb, self.t_cb,
                        estimate_scale=is_mono)
                if is_mono:
                    # the scale guard (LocalMapping.cc:1689-1698): retry at
                    # the next keyframe; repeated failures declare the IMU
                    # bad and reset the map (LocalMapping.cc:170-177)
                    s_host = float(s)
                    if not 0.1 < s_host < 1e3:
                        self._imu_init_failures += 1
                        if self._imu_init_failures >= 8:
                            self._imu_init_failures = 0
                            self._reset_active_map()
                        return
                self._imu_init_failures = 0
                self.ikf, self.gravity = ikf2, g2
                if is_mono:
                    self._apply_map_scale(s, s_host)
                self.imu_initialized = True
                self._init_kf_count = self.n_kf
                # bFIBA: whole-map VI BA with bias priors right after init
                # (LocalMapping.cc:1712-1720), as three background slices
                for _ in range(3):
                    self._bg_push("init_fiba", self._init_fiba_apply)
            elif self.n_kf >= 2:
                # before IMU init the visual local BA runs inline, to its end
                self.ms = tracking.local_ba_step(
                    self.ms, self.n_kf - 1, self.cam_params, cam.bf,
                    window=min(8, self.cfg.capacity.max_local_kfs),
                    lm_cap=self.cfg.capacity.max_local_landmarks, cam_model=self.cam_model, rig=self.rig,
                )
                self.ms = tracking.cull_landmarks(self.ms)
        else:
            # VI local BA and landmark culling as background slices
            self._schedule_local_ba(self.n_kf - 1)
            self._bg_push("cull_lm", self._cull_landmarks_slice)
            # VIBA1/VIBA2 (LocalMapping.cc:238-295): re-estimate gravity,
            # biases and velocities once more map and motion accumulated
            # (mono also refines the map scale: ScaleRefinement)
            if self.n_kf in (self._init_kf_count + 6, self._init_kf_count + 14):
                with self.timer.span("mapping/imu_init"):
                    ikf2, g2, s = inertial.initialize_imu(
                        self.ms, self.ikf, self.n_kf, self.gravity, self.R_cb, self.t_cb,
                        estimate_scale=is_mono)
                if not is_mono:
                    self.ikf, self.gravity = ikf2, g2
                else:
                    # the map is metric already: a refinement far from 1 is
                    # noise, and the gauge stays
                    s_host = float(s)
                    if 0.5 < s_host < 2.0:
                        self.ikf, self.gravity = ikf2, g2
                        self._apply_map_scale(s, s_host)
            self._bg_push("loop", self._maybe_close_loop)
        # the Atlas merge across shelved maps (MergeLocal2 for inertial maps,
        # LoopClosing.cc:1837), whether or not this map's IMU is initialized
        if self.atlas_maps and self.enable_loop_closing:
            self._bg_drop(("try_merge",))
            self._bg_push("try_merge", functools.partial(map_merging.try_merge, self))
        self._bg_backpressure()

    def _apply_map_scale(self, s, s_host: float) -> None:
        """Re-gauge the map and the live pose by the VI-solved metric scale
        ``s`` (a 0-d tensor; ``s_host`` its value, read once by the caller;
        Map::ApplyScaledRotation's scale part, ``Map.cc:289``). The active
        map's recorded trajectory shares the old gauge and is re-gauged too
        (the reference gets this by storing frame poses relative to their
        keyframe, ``System.cc:503``)."""
        self.ms = msx.apply_scale(self.ms, s)
        self.t_cw = self.t_cw * s
        self.vel_t = self.vel_t * s
        gen = self._map_gen
        self.trajectory = [
            (t, g, kf, R_rel, None if t_rel is None else t_rel * s_host, R_abs, t_abs * s_host)
            if g == gen else (t, g, kf, R_rel, t_rel, R_abs, t_abs)
            for (t, g, kf, R_rel, t_rel, R_abs, t_abs) in self.trajectory
        ]

    def _triangulate_new_points(self, kf_idx: int) -> None:
        """Monocular keyframes have no stereo depth: new points come from
        triangulation against the top-5 covisible neighbours, best-parallax
        pick (CreateNewMapPoints)."""
        cam, orb = self.cfg.camera, self.cfg.orb
        feat_b, X_w, want, nb = tracking.triangulate_with_neighbor(
            self.ms, kf_idx, self.cam_params, w=cam.width, h=cam.height, scale=orb.scale_factor,
            n_levels=orb.n_levels, cam_model=self.cam_model, far_dist=cam.th_far_points,
        )
        self.ms = tracking.add_triangulated_landmarks(
            self.ms, kf_idx, nb, torch.where(want, feat_b, -1), X_w, want, self.cam_params,
            scale=orb.scale_factor, n_levels=orb.n_levels,
        )

    #: the window of one dense-Schur slice of the post-init FullInertialBA
    #: (bFIBA), and of the inertial GBA sweep
    _INIT_FIBA_WINDOW = 16

    def _init_fiba_slice(self):
        return inertial.local_vi_ba_step(
            self.ms, self.ikf, self.n_kf - 1, self.gravity, self.cam_params, self.R_cb, self.t_cb,
            self.cfg.camera.bf, window=self._INIT_FIBA_WINDOW,
            lm_cap=self.cfg.capacity.max_local_landmarks, iters=2, cam_model=self.cam_model, rig=self.rig,
            prior_bg_info=1e2, prior_ba_info=1e5,
        )

    def _init_fiba_apply(self) -> None:
        self.ms, self.ikf, _ = self._init_fiba_slice()

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
        if self.localization_only:
            return False
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
        if self.cfg.is_inertial and self.n_kf > 2:
            # never cull a keyframe whose removal leaves a window over 3 s
            # (the inertial culling rule, LocalMapping.cc:1194-1399)
            times = self._host_kf_times()
            for i in range(1, self.n_kf - 1):
                if times[i + 1] - times[i - 1] > 3.0:
                    protect[i] = True
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
        if self.cfg.is_inertial:
            # the validity before compaction drives the chain merge
            self.ikf = inertial.merge_and_compact(self.ikf, self.ms.kf_valid)
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
        corrected (essential graph: SE(3) stereo, Sim(3) monocular, 4-DoF
        inertial), followed by duplicate fusion of
        the recent landmarks, the re-basing of the live pose and four GBA
        slices."""
        if not self.enable_loop_closing or self.localization_only:
            return
        # an inertial map is corrected only once its IMU is initialized
        # (LoopClosing.cc:366-389)
        if self.cfg.is_inertial and not self.imu_initialized:
            return
        if flush:
            kf_idx, cand = self.loop_closer.poll_detect()
        else:
            kf_idx, cand = self.loop_closer.detect_async(self.ms, self.n_kf - 1, self.n_kf)
        # the essential graph per sensor (LoopClosing.cc:1239-1245): inertial
        # maps 4-DoF (gravity stays observable), monocular maps Sim(3)
        # (scale drifts), stereo maps SE(3)
        if self.cfg.is_inertial:
            mode, gravity = "4dof", self.gravity
        elif self.cfg.sensor == SensorType.MONOCULAR:
            mode, gravity = "sim3", None
        else:
            mode, gravity = "se3", None
        fix_scale = mode != "sim3"
        lc = self.loop_closer
        ok = False
        if cand < 0:
            if lc._hyp is not None:
                acc, c_h, R_d, t_d, s_d = lc.hypothesis_step(
                    self.ms, self.n_kf - 1, self.cam_params, cam_model=self.cam_model,
                    fix_scale=fix_scale,
                )
                if not acc:
                    return
                kf_idx, cand, ok = self.n_kf - 1, c_h, True
                lc._closure_src = "hyp"
            elif kf_idx >= 0 and lc._consecutive == 1 and lc._last_cand >= 0:
                # a fresh unconfirmed BoW hit seeds a hypothesis with a full
                # geometric verification
                ok_seed, R_s, t_s, s_s = lc.verify(
                    self.ms, kf_idx, lc._last_cand, self._split_key(), fix_scale=fix_scale,
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
                    self.ms, kf_idx, c, self._split_key(), fix_scale=fix_scale,
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
        if self.cfg.is_inertial:
            # velocities turn with each keyframe's pose-graph correction
            self.ms, self.ikf = lc.correct(
                self.ms, self.n_kf, kf_idx, cand, R_d, t_d, self.cam_params, self.cfg.camera.bf,
                mode=mode, gravity=gravity, s_delta=s_d, run_gba=False, ikf=self.ikf,
            )
        else:
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
        if self.cfg.sensor == SensorType.MONOCULAR and self.n_kf >= 3:
            self._triangulate_new_points(self.n_kf - 1)
        if self.n_kf >= 2:
            # every per-KF mapping job is a bounded slice on the background
            # FIFO, one dispatched ahead of each subsequent frame
            kf_host = self.n_kf - 1
            self._bg_push("fuse", functools.partial(self._fuse_new_duplicates, kf_host))
            self._schedule_local_ba(kf_host)
            self._bg_push("cull_lm", self._cull_landmarks_slice)
            # redundant-KF culling, every 3rd keyframe (visual maps only: the
            # inertial chain keeps its keyframes)
            if not self.cfg.is_inertial and self.n_kf > 6 and kf_host % 3 == 0:
                self._bg_drop(("cull_kf",))
                self._bg_push("cull_kf", self._cull_redundant_slice)
            self._bg_push("loop", self._maybe_close_loop)
            if self.atlas_maps and self.enable_loop_closing:
                # Atlas merge: while shelved maps exist, every new keyframe
                # is probed for overlap with them (LoopClosing.cc:1288)
                self._bg_drop(("try_merge",))
                self._bg_push("try_merge", functools.partial(map_merging.try_merge, self))
            # the live tracking pose is deliberately NOT overwritten by the
            # BA result: the tracker re-aligns at the next frame
            self._bg_backpressure()

    # ------------------------------------------------------------------
    def save_map(self, path: str) -> None:
        """Snapshot the map and the tracking state (``slam/checkpoint.py``):
        the reference's ``.npz`` layout, which either package loads."""
        self.flush_decisions()
        checkpoint.save_map(self, path)

    def load_map(self, path: str) -> None:
        """Restore a snapshot made by either package's ``save_map`` (same
        configuration)."""
        checkpoint.load_map(self, path)

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
