"""The JAX reference's runs of the monocular passes of chip_smoke.py phases 9 and 10.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_mono_ref.py --pass mono   # phase 9, REF_MONO
    JAX_PLATFORMS=cpu python tools/jax_mono_ref.py --pass mi     # phase 10, REF_MI

``mono``: bench.py's stereo configuration (``bench.py:39-57``: 480x752,
1200 features, 64 keyframes, 16,384 landmarks, 4,096 local,
``max_frames_between_kf=10``) with ``sensor=MONOCULAR`` and ``bf=0``, fed
the left images of bench.py's 130-frame strafe sequence (0.03 m/frame,
chip_smoke.py phase 4's) through ``SlamSystem.track_mono`` at 20 fps
timestamps, loop closing on (the default). Prints one JSON line: the
two-view initialization frame, the keyframes and the frames that inserted
them, the loops closed and each correction's mode, the frames decided
lost, the final state, ``eval.ate.ate_rmse`` over all frames with scale
alignment (and without), the landmarks and the run's seconds.

``mi``: the same geometry with ``sensor=IMU_MONOCULAR``, a 200 Hz IMU and
``max_frames_between_kf=6`` (as ``tests/test_mono_inertial.py:26-39``),
fed 130 frames of ``synthetic.AnalyticTrajectory(excitation=3.0)`` at 20
fps with the IMU samples made as ``bench.py:301-324`` makes them, through
``track_mono_inertial``. Prints the two-view initialization frame, the
frame, keyframe count and gravity at IMU initialization, the keyframes,
the final state and gravity, the ATE without scale alignment (and with),
the stride-10 path-length ratio of ``tests/test_mono_inertial.py:98-101``,
the loops, the frames decided lost, the lifecycle counters and the seconds.

Both runs use one JAX device with the CPU's asynchronous dispatch off, so
that every deferred decision read is ready at its first chance, as on the
H100, where the tracking step is host-bound. ``--out`` also writes the
per-frame trajectory and the ground truth to an npz.
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
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem, TrackingState  # noqa: E402

H, W, FX, FPS, IMU_RATE, N_FRAMES, SPEED = 480, 752, 458.0, 20.0, 200.0, 130, 0.03


def config(sensor, kf_gap):
    return SLAMConfig(
        sensor=sensor,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=0.0),
        orb=ORBConfig(n_features=1200, cell_size=32),
        imu=IMUConfig(frequency=IMU_RATE),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=kf_gap),
    )


def instrument(slam, counts):
    """Count the frames decided lost and log each loop correction."""
    handle_lost = slam._handle_lost

    def lost_counted(frame):
        counts["lost_frames"] += 1
        return handle_lost(frame)
    slam._handle_lost = lost_counted
    correct = loop_closing.LoopCloser.correct

    def correct_logged(self, *a, **k):
        counts["corrections"].append([slam.n_frames - 1, int(a[2]), int(a[3]), k.get("mode", "se3")])
        return correct(self, *a, **k)
    loop_closing.LoopCloser.correct = correct_logged


def imu_samples(traj, i):
    """bench.py's samples between frames i-1 and i (midpoint-sampled,
    stamped at the end of their interval)."""
    if i == 0:
        return []
    t, t0 = i / FPS, (i - 1) / FPS
    n = int(round((t - t0) * IMU_RATE))
    dt = (t - t0) / n
    out = []
    for k in range(n):
        acc, gyro = traj.imu_at(t0 + (k + 0.5) * dt)
        out.append((t0 + (k + 1) * dt, np.asarray(acc), np.asarray(gyro)))
    return out


def run(kind):
    inertial = kind == "mi"
    cfg = config(SensorType.IMU_MONOCULAR if inertial else SensorType.MONOCULAR, 6 if inertial else 10)
    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    slam = SlamSystem(cfg)
    counts = {"lost_frames": 0, "corrections": []}
    instrument(slam, counts)
    if inertial:
        traj = synthetic.AnalyticTrajectory(excitation=3.0)
    else:
        Rs, ts = synthetic.make_trajectory(N_FRAMES, motion="strafe", speed=SPEED)
    t0 = time.time()
    kf_at, gt, init, imu_init = [], [], None, None
    for i in range(N_FRAMES):
        t = i / FPS
        n0 = slam.stats["kf_inserted"]
        if inertial:
            R_wb, p_wb = traj.pose(t)
            gt.append(np.asarray(p_wb))
            img, _ = synthetic.render(params, R_wb, p_wb, scene, h=H, w=W)
            slam.track_mono_inertial(img, t, imu_samples(traj, i))
        else:
            gt.append(ts[i])
            img, _ = synthetic.render(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), scene, h=H, w=W)
            slam.track_mono(img, t)
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and slam.state == TrackingState.OK:
            init = i
        if inertial and imu_init is None and slam.imu_initialized:
            imu_init = {"frame": i, "n_kf": slam.n_kf, "gravity": np.asarray(slam.gravity).tolist()}
    slam.flush_decisions()
    gt = np.stack(gt)
    times, centers, R_wc = slam.trajectory_arrays()
    g = gt[: len(centers)]
    out = {
        "pass": kind, "init_frame": init, "state": slam.state, "n_kf": slam.n_kf, "keyframe_frames": kf_at,
        "loops_closed": slam.loop_closer.n_loops_closed, **counts, "stats": slam.stats,
        "frames": len(centers), "landmarks": int(np.asarray(slam.ms.lm_valid).sum()),
        "ate_scale_aligned_m": float(ate.ate_rmse(centers, g, with_scale=True)),
        "ate_m": float(ate.ate_rmse(centers, g)),
    }
    if inertial:
        c10, g10 = centers[::10], g[::10]
        out.update(
            imu_init=imu_init, gravity_end=np.asarray(slam.gravity).tolist(),
            imu_initialized=bool(slam.imu_initialized),
            path_ratio_stride10=float(np.linalg.norm(np.diff(c10, axis=0), axis=1).sum()
                                      / np.linalg.norm(np.diff(g10, axis=0), axis=1).sum()),
        )
    out["seconds"] = time.time() - t0
    return out, (times, centers, R_wc, g)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pass", dest="kind", choices=("mono", "mi"), required=True)
    ap.add_argument("--out", default=None, help="npz for the per-frame trajectory")
    args = ap.parse_args()
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    assert len(jax.devices()) == 1, "run on one JAX device"
    out, (times, centers, R_wc, gt) = run(args.kind)
    print(json.dumps(out))
    if args.out:
        np.savez(args.out, times=times, centers=centers, R_wc=R_wc, gt=gt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
