"""The system under test: the PyTorch and CUDA port, driven through its
public entry points, and what the benchmark reads back from it.

This is the only module of the benchmark that imports the port
(``orb_slam3_detailed_comments_kor_tpu_torch``), and it does so inside its
functions. From the port it takes the system (``SlamSystem`` and its
``track_stereo`` / ``track_stereo_inertial``), its kernel library build,
its ``StageTimer`` spans and its state as the timed path left it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernel
    library; it lives in the port's ``_build/``, keyed by a hash of its
    sources."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    _cuda.library()


def frozen_local_ba() -> None:
    """A fault for the control runs: local bundle adjustment (visual and
    visual-inertial) returns the map it was given."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial, tracking

    tracking.local_ba_step = lambda ms, *a, **k: ms
    inertial.local_vi_ba_step = lambda ms, ikf, *a, **k: (ms, ikf, None)


FAULTS = {"frozen_local_ba": frozen_local_ba}


def slam_config(cfg: dict):
    """The port's ``SLAMConfig`` for a configuration file's settings."""
    from orb_slam3_detailed_comments_kor_tpu_torch import config as C

    sensor = {"stereo": C.SensorType.STEREO, "stereo_inertial": C.SensorType.IMU_STEREO}[cfg["sensor"]]
    cam = dict(cfg["camera"])
    imu = dict(cfg.get("imu") or {})
    if "tbc" in imu:
        imu["tbc"] = tuple(float(v) for v in imu["tbc"])
    return C.SLAMConfig(
        sensor=sensor,
        camera=C.CameraConfig(**cam),
        orb=C.ORBConfig(**cfg["orb"]),
        imu=C.IMUConfig(**imu),
        tracking=C.TrackingConfig(**cfg.get("tracking", {})),
        capacity=C.CapacityConfig(**cfg.get("capacity", {})),
    )


def timeline_timer(enabled: bool):
    """The port's ``StageTimer``, also keeping each span's (start, end)
    on the monotonic clock (ns), so that the trace's idle gaps can be named
    by the span the host was in."""
    import contextlib

    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    class TimelineTimer(StageTimer):
        def __init__(self, enabled: bool):
            super().__init__(enabled)
            self.intervals: List[Tuple[int, int, str]] = []

        @contextlib.contextmanager
        def span(self, name: str):
            if not self.enabled:
                yield
                return
            full = "/".join(self._stack + [name])
            t0 = time.perf_counter_ns()
            with super().span(name):
                yield
            self.intervals.append((t0, time.perf_counter_ns(), full))

        def reset(self) -> None:
            self.samples = {}
            self.intervals = []

    return TimelineTimer(enabled)


class System:
    """One ``SlamSystem`` on ``device`` for a configuration file."""

    def __init__(self, cfg: dict, device, timer_enabled: bool):
        from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem, TrackingState

        self.cfg = cfg
        self.inertial = cfg["sensor"] == "stereo_inertial"
        self.slam = SlamSystem(slam_config(cfg), device=device)
        self.slam.enable_loop_closing = bool(cfg.get("loop_closing", True))
        self.slam.timer = timeline_timer(timer_enabled)
        self.OK = TrackingState.OK

    @property
    def timer(self):
        return self.slam.timer

    def feed(self, seq, i: int) -> int:
        """Hand frame i over as a decoder would (host uint8 arrays); returns
        the tracking state after the call."""
        left, right = seq.images[i, 0], seq.images[i, 1]
        t = float(seq.times[i])
        if self.inertial:
            return self.slam.track_stereo_inertial(left, right, t, seq.imu_samples(i))
        return self.slam.track_stereo(left, right, t)

    def read_pose(self) -> np.ndarray:
        """The newest pose on the host (waits for the frame's device work)."""
        return self.slam.t_cw.cpu().numpy()

    def inertial_ready(self) -> bool:
        """The IMU is initialised and its three init-FIBA slices have run."""
        s = self.slam
        return bool(s.imu_initialized) and not any(k == "init_fiba" for k, _ in s._bg_queue)

    def n_keyframes(self) -> int:
        return int(self.slam.n_kf)

    def flush(self) -> None:
        """Resolve the deferred decisions and run the queued mapping work,
        as a recording's end does."""
        self.slam.flush_decisions()

    def outputs(self, t_from: float) -> Dict[str, np.ndarray]:
        """What the timed path produced, on the host: every frame's pose
        (composed with its reference keyframe's final pose, as the
        trajectory writer does) and the keyframes stamped at or after
        ``t_from`` with their features, observations and landmarks, every
        keyframe's pose and observations, and (inertial) the window
        keyframes' stored preintegration."""
        s = self.slam
        ts, centres, _ = s.trajectory_arrays()
        ms = s.ms
        kf_time = ms.kf_time.cpu().numpy()
        kf_valid = ms.kf_valid.cpu().numpy()
        every = np.nonzero(kf_valid)[0]
        every = every[np.argsort(kf_time[every], kind="stable")]
        sel = every[kf_time[every] >= t_from - 1e-4]
        dev = ms.kf_time.device
        rows = lambda x, idx: x[torch.from_numpy(idx).to(dev)].cpu().numpy()
        obs_all = rows(ms.obs_lm, every)
        feat_all = rows(ms.kf_feat_valid, every)
        used = np.unique(obs_all[(obs_all >= 0) & feat_all])
        lm_idx = torch.from_numpy(used).to(dev)
        host = lambda x: rows(x, sel)
        out = dict(
            traj_t=np.asarray(ts, np.float64), traj_centres=np.asarray(centres, np.float64),
            kf_time=kf_time[sel], all_kf_time=np.sort(kf_time[kf_valid]),
            kf_R_cw=host(ms.kf_R_cw), kf_t_cw=host(ms.kf_t_cw), kf_xy=host(ms.kf_xy), kf_level=host(ms.kf_level),
            kf_desc=host(ms.kf_desc), kf_ur=host(ms.kf_ur), kf_feat_valid=host(ms.kf_feat_valid), obs_lm=host(ms.obs_lm),
            lm_ids=used, lm_pos=ms.lm_pos[lm_idx].cpu().numpy(), lm_valid=ms.lm_valid[lm_idx].cpu().numpy(),
            # every keyframe of the map, oldest first (the bundle-adjustment check)
            map_kf_time=kf_time[every], map_R_cw=rows(ms.kf_R_cw, every), map_t_cw=rows(ms.kf_t_cw, every),
            map_xy=rows(ms.kf_xy, every), map_ur=rows(ms.kf_ur, every), map_level=rows(ms.kf_level, every),
            map_obs=np.where(feat_all, obs_all, -1),
        )
        if self.inertial:
            k = s.ikf
            out.update(pre_valid=host(k.pre_valid), pre_dR=host(k.pre_dR), pre_dV=host(k.pre_dV),
                       pre_dP=host(k.pre_dP))
        return out
