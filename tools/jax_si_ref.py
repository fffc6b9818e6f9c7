"""The JAX reference's run of the stereo-inertial pass of chip_smoke.py phase 8.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_si_ref.py [--out traj.npz]

Builds bench.py's stereo-inertial configuration (``build_config(True)``,
``bench.py:39-57``: IMU_STEREO, 480x752, 1200 features, 64 keyframes,
16,384 landmarks, 4,096 local, ``max_frames_between_kf=10``, a 200 Hz
IMU), renders bench.py's 130 frames of ``synthetic.AnalyticTrajectory``
with the IMU samples made as in ``bench.py:301-324``, and feeds them to the
JAX package's ``SlamSystem`` with its defaults (loop closing on), one frame
at a time at 20 fps timestamps, through ``track_stereo_inertial``. Prints
one JSON line: ``eval.ate.ate_rmse`` over all frames, the final state, the
keyframes and the frames that inserted them, the keyframe count and frame
at IMU initialization, gravity right after initialization and at the end,
the loops closed and the mode of each correction, the frames decided lost,
the lifecycle counters and the run's seconds. chip_smoke.py records these
as ``REF_SI``. ``--out`` also writes the per-frame trajectory and the
ground truth to an npz.

The tool runs on one JAX device (a runtime with several would route the
inertial global BA to ``parallel/dist_vi_ba``) with the CPU's asynchronous
dispatch off, so that every deferred decision read is ready at its first
chance, as on the H100, where the tracking step is host-bound.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu.config import (  # noqa: E402
    CameraConfig, CapacityConfig, IMUConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
)
from orb_slam3_detailed_comments_kor_tpu.eval import ate  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.io import synthetic  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem  # noqa: E402

H, W, FX, BASELINE, FPS, IMU_RATE, N_FRAMES = 480, 752, 458.0, 0.11, 20.0, 200.0, 130


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="npz for the per-frame trajectory")
    args = ap.parse_args()
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    assert len(jax.devices()) == 1, "run on one JAX device"
    cfg = SLAMConfig(
        sensor=SensorType.IMU_STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=1200, cell_size=32),
        imu=IMUConfig(frequency=IMU_RATE),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )
    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    traj = synthetic.AnalyticTrajectory()
    slam = SlamSystem(cfg)
    counts = {"lost_frames": 0, "corrections": []}
    handle_lost = slam._handle_lost

    def lost_counted(frame):
        counts["lost_frames"] += 1
        return handle_lost(frame)
    slam._handle_lost = lost_counted
    correct = loop_closing.LoopCloser.correct

    def correct_logged(self, *a, **k):
        counts["corrections"].append([slam.n_frames - 1, k.get("mode", "se3")])
        return correct(self, *a, **k)
    loop_closing.LoopCloser.correct = correct_logged

    t0 = time.time()
    kf_at, gt, init = [], [], None
    for i in range(N_FRAMES):
        t = i / FPS
        R_wb, p_wb = traj.pose(t)
        gt.append(np.asarray(p_wb))
        il, ir, _ = synthetic.stereo_pair(params, R_wb, p_wb, BASELINE, scene, h=H, w=W)
        samples = []
        if i > 0:
            t0s = (i - 1) / FPS
            n = int(round((t - t0s) * IMU_RATE))
            dt = (t - t0s) / n
            for k in range(n):
                acc, gyro = traj.imu_at(t0s + (k + 0.5) * dt)
                samples.append((t0s + (k + 1) * dt, np.asarray(acc), np.asarray(gyro)))
        n0 = slam.stats["kf_inserted"]
        slam.track_stereo_inertial(il, ir, t, samples)
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and slam.imu_initialized:
            init = {"frame": i, "n_kf": slam.n_kf, "gravity": np.asarray(slam.gravity).tolist()}
    gt = np.stack(gt)
    times, centers, R_wc = slam.trajectory_arrays()
    lc = slam.loop_closer
    print(json.dumps({
        "ate_m": float(ate.ate_rmse(centers, gt[: len(centers)])), "state": slam.state,
        "n_kf": slam.n_kf, "keyframe_frames": kf_at, "imu_init": init,
        "gravity_end": np.asarray(slam.gravity).tolist(), "loops_closed": lc.n_loops_closed,
        **counts, "stats": slam.stats, "frames": len(centers),
        "landmarks": int(np.asarray(slam.ms.lm_valid).sum()), "seconds": time.time() - t0,
    }))
    if args.out:
        np.savez(args.out, times=times, centers=centers, R_wc=R_wc, gt=gt[: len(centers)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
