"""The JAX reference's runs of the RGB-D and fisheye passes of chip_smoke.py phases 11-13.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass rgbd --frames 60     # phase 11, REF_RGBD
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass fisheye --frames 40  # phase 12, REF_FISHEYE
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass fsi --frames 80  # phase 13, REF_FSI
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass si --frames 90     # phase 8, REF_SI
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass mono --frames 70   # phase 9, REF_MONO
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass mi --frames 60     # phase 10, REF_MI
    JAX_PLATFORMS=cpu python tools/jax_sensor_ref.py --pass euroc --frames 130  # phase 14, REF_EUROC

``rgbd``: bench.py's stereo camera and ORB settings (``bench.py:39-57``:
480x752, fx 458, 1200 features, 8 levels, 64 keyframes, 16,384 landmarks,
4,096 local, ``max_frames_between_kf=10``, bf = 0.11 m x fx) with
``sensor=RGBD``, fed bench.py's 130-frame strafe (0.03 m/frame,
chip_smoke.py phase 4's) as the left image and the left camera's rendered
depth through ``SlamSystem.track_rgbd`` at 20 fps timestamps.

``fisheye``: the same capacity, ORB and keyframe settings on TUM-VI's
512x512 Kannala-Brandt calibration (the JAX package's
``tests/test_camera.py:12``) for both cameras, ``Tlr`` a pure 0.10 m
x-offset of the right camera (as ``tests/test_fisheye.py:104-119``), bf =
0.10 m x fx, ``sensor=STEREO``, fed the same strafe as raw fisheye pairs
through ``track_stereo``.

``fsi``: that rig with bench.py's stereo-inertial settings
(``build_config(True)``: ``IMU_STEREO``, a 200 Hz IMU), fed bench.py's
130 frames of ``synthetic.AnalyticTrajectory`` with its IMU samples
(``bench.py:301-324``) through ``track_stereo_inertial`` (TUM-VI's own
mode).

``si``, ``mono``, ``mi``: ``tools/jax_si_ref.py`` (phase 8's
stereo-inertial pass) and ``tools/jax_mono_ref.py --pass mono|mi``
(phases 9 and 10) cut to their first ``--frames`` frames, the depths
chip_smoke.py runs them at; each prints that tool's JSON line, ``mi``'s
with the metric scale of each scale-estimating IMU initialization
(``imu_scales``). chip_smoke.py's REF_MI_ORDERS are the ``mi`` pass under
two other float associations of the reference's:
``XLA_FLAGS=--xla_cpu_enable_fast_math=true`` and
``XLA_FLAGS=--xla_cpu_multi_thread_eigen=false``.

``euroc``: phase 8's stereo-inertial data (bench.py's 480x752 pinhole pair
on ``synthetic.AnalyticTrajectory`` at 20 fps with its 200 Hz samples),
rendered by the JAX package, written by ``chip_smoke.write_euroc_sequence``
in the EuRoC MAV layout (8-bit PNGs, ``imu0/data.csv``, the ground truth
and a settings YAML with rectification blocks) with EuRoC-like absolute
stamps from ``chip_smoke.DS_T0_NS``, into a temporary directory, and run by
the repository's ``examples/run_dataset.py`` (``--mode stereo_inertial
--dataset euroc``), as chip_smoke.py phase 14 runs the port's runner; the
line adds the IMU-initialization frame and keyframes, the frames decided
lost and the runner's ATE.

Loop closing is on in all of them (the default). Each prints one JSON line:
the final state, the keyframes and the frames that inserted them, the
loops closed and each correction's mode, the frames decided lost, the
lifecycle counters, the landmarks, ``eval.ate.ate_rmse`` over all frames
without scale alignment, the valid right-camera rows of the newest
keyframe (fisheye passes), the IMU-initialization frame, keyframe count
and gravity, the final gravity and, when the pass ends before VIBA1, the
gravity of that re-initialization run once on the final map as the
system runs it (``viba1_gravity``, ``fsi``), and the run's seconds.
chip_smoke.py records these as ``REF_RGBD``, ``REF_FISHEYE`` and
``REF_FSI``. The runs use one JAX device with the CPU's asynchronous
dispatch off and every deferred read counted as ready once computed
(``first_chance_reads``), so that every deferred decision read is ready
at its first chance, as on the H100, where the tracking step is
host-bound. ``--out``
also writes the per-frame trajectory and the ground truth to an npz.
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
from orb_slam3_detailed_comments_kor_tpu.slam import inertial, loop_closing  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem  # noqa: E402

H, W, FX, BASELINE, FPS, IMU_RATE, N_FRAMES, SPEED = 480, 752, 458.0, 0.11, 20.0, 200.0, 130, 0.03
# TUM-VI's 512x512 Kannala-Brandt calibration, both cameras
KB8 = (190.978, 190.973, 254.932, 256.897, 0.00348, 0.000715, -0.00205, 0.000581)
FISH_HW, FISH_BASE = 512, 0.10


def config(kind):
    orb = ORBConfig(n_features=1200, cell_size=32)
    cap = CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096)
    tracking = TrackingConfig(max_frames_between_kf=10)
    if kind == "rgbd":
        cam = CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX)
        return SLAMConfig(sensor=SensorType.RGBD, camera=cam, orb=orb, capacity=cap, tracking=tracking)
    tlr = (1.0, 0.0, 0.0, FISH_BASE, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    cam = CameraConfig(width=FISH_HW, height=FISH_HW, fx=KB8[0], fy=KB8[1], cx=KB8[2], cy=KB8[3],
                       bf=FISH_BASE * KB8[0], model="kannala_brandt8", dist=KB8[4:], right_intrinsics=KB8,
                       tlr=tlr)
    sensor = SensorType.IMU_STEREO if kind == "fsi" else SensorType.STEREO
    return SLAMConfig(sensor=sensor, camera=cam, orb=orb, imu=IMUConfig(frequency=IMU_RATE), capacity=cap,
                      tracking=tracking)


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


def run(kind, frames=N_FRAMES):
    cfg = config(kind)
    scene = synthetic.default_scene()
    slam = SlamSystem(cfg)
    counts = {"lost_frames": 0, "corrections": []}
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
    if kind == "rgbd":
        params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    else:
        params = jnp.array(KB8)
    if kind == "fsi":
        traj = synthetic.AnalyticTrajectory()
    else:
        Rs, ts = synthetic.make_trajectory(frames, motion="strafe", speed=SPEED)
    c = cfg.camera
    t0 = time.time()
    kf_at, gt, imu_init = [], [], None
    for i in range(frames):
        t = i / FPS
        if kind == "fsi":
            R_wc, t_wc = traj.pose(t)
        else:
            R_wc, t_wc = jnp.asarray(Rs[i]), jnp.asarray(ts[i])
        gt.append(np.asarray(t_wc))
        n0 = slam.stats["kf_inserted"]
        if kind == "rgbd":
            img, depth = synthetic.render(params, R_wc, t_wc, scene, h=c.height, w=c.width)
            slam.track_rgbd(img, depth, t)
        else:
            il, ir, _ = synthetic.stereo_pair(params, R_wc, t_wc, FISH_BASE, scene, h=c.height, w=c.width,
                                              model="kannala_brandt8")
            if kind == "fsi":
                slam.track_stereo_inertial(il, ir, t, imu_samples(traj, i))
            else:
                slam.track_stereo(il, ir, t)
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if kind == "fsi" and imu_init is None and slam.imu_initialized:
            imu_init = {"frame": i, "n_kf": slam.n_kf, "gravity": np.asarray(slam.gravity).tolist()}
    slam.flush_decisions()
    gt = np.stack(gt)
    times, centers, R_wc = slam.trajectory_arrays()
    out = {
        "pass": kind, "state": slam.state, "n_kf": slam.n_kf, "keyframe_frames": kf_at,
        "loops_closed": slam.loop_closer.n_loops_closed, **counts, "stats": slam.stats,
        "frames": len(centers), "landmarks": int(np.asarray(slam.ms.lm_valid).sum()),
        "ate_m": float(ate.ate_rmse(centers, gt[: len(centers)])),
    }
    if kind != "rgbd":
        k = slam.n_kf - 1
        uvr = np.asarray(slam.ms.kf_uvr[k])
        out["rig_rows_newest_kf"] = int(((uvr[:, 0] >= 0) & np.asarray(slam.ms.kf_feat_valid[k])).sum())
    if kind == "fsi":
        out.update(imu_init=imu_init, imu_initialized=bool(slam.imu_initialized),
                   gravity_end=np.asarray(slam.gravity).tolist())
        if slam.imu_initialized and slam.n_kf < slam._init_kf_count + 6:
            # VIBA1 (the system's re-initialization at the init's keyframes
            # + 6), run once on the final map with the system's arguments
            _, g1, _ = inertial.initialize_imu(slam.ms, slam.ikf, slam.n_kf, slam.gravity, slam.R_cb, slam.t_cb,
                                               estimate_scale=False)
            out["viba1_gravity"] = np.asarray(g1).tolist()
    out["seconds"] = time.time() - t0
    return out, (times, centers, R_wc, gt[: len(centers)])


def first_chance_reads():
    """Make every deferred read count as ready once its value is computed,
    as on the H100, where the tracking step is host-bound. With the CPU's
    asynchronous dispatch off a batched decision read was still found not
    ready at its first chance in some runs (the ``euroc`` pass's first
    batch consumed at frame 6 of 130, at frame 5 in a 12-frame run; the
    90-frame ``fisheye`` pass's keyframes one frame late), moving every
    keyframe after it by one frame."""
    from jax._src import array as jarray

    jarray.ArrayImpl.is_ready = lambda self: self.block_until_ready() is not None


def run_euroc(frames):
    """The ``euroc`` pass: write the sequence, run the JAX package's dataset
    runner on it and read what it did per frame."""
    import tempfile

    import chip_smoke
    from examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu.slam import system as jsys

    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    traj = synthetic.AnalyticTrajectory()
    pairs, imu, gt_pos, gt_R = [], [], [], []
    for i in range(frames):
        R_wb, p_wb = traj.pose(i / FPS)
        gt_pos.append(np.asarray(p_wb))
        gt_R.append(np.asarray(R_wb))
        il, ir, _ = synthetic.stereo_pair(params, R_wb, p_wb, BASELINE, scene, h=H, w=W)
        pairs.append((np.asarray(il), np.asarray(ir)))
        imu.append(imu_samples(traj, i))
    rec = {"kf_at": [], "init": None, "lost_frames": 0, "corrections": [], "slam": None, "calls": 0}
    track, handle_lost = jsys.SlamSystem.track_stereo_inertial, jsys.SlamSystem._handle_lost
    correct = loop_closing.LoopCloser.correct

    def tracked(self, *a, **k):
        rec["slam"], i, n0 = self, rec["calls"], self.stats["kf_inserted"]
        rec["calls"] += 1
        out = track(self, *a, **k)
        if self.stats["kf_inserted"] != n0:
            rec["kf_at"].append(i)
        if rec["init"] is None and self.imu_initialized:
            rec["init"] = {"frame": i, "n_kf": self.n_kf,
                           "gravity": np.asarray(self.gravity).tolist()}
        return out

    def lost_counted(self, frame):
        rec["lost_frames"] += 1
        return handle_lost(self, frame)

    def correct_logged(self, *a, **k):
        rec["corrections"].append([int(a[2]), int(a[3]), k.get("mode", "se3")])
        return correct(self, *a, **k)
    jsys.SlamSystem.track_stereo_inertial, jsys.SlamSystem._handle_lost = tracked, lost_counted
    loop_closing.LoopCloser.correct = correct_logged
    t0 = time.time()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root, settings, gt_path, _ = chip_smoke.write_euroc_sequence(
                tmp, euroc_config(), pairs, imu, gt_pos, gt_R, fps=FPS)
            out_path = os.path.join(tmp, "trajectory.csv")
            run_dataset.main(["--mode", "stereo_inertial", "--dataset", "euroc", "--seq", root,
                              "--settings", settings, "--out", out_path, "--gt", gt_path])
            rows = np.loadtxt(out_path, delimiter=",", ndmin=2)
            gt = np.loadtxt(gt_path, delimiter=",", comments="#")
    finally:
        jsys.SlamSystem.track_stereo_inertial, jsys.SlamSystem._handle_lost = track, handle_lost
        loop_closing.LoopCloser.correct = correct
    slam = rec["slam"]
    times, centers, R_wc = slam.trajectory_arrays()
    i_est, i_gt = ate.associate_timestamps(times, gt[:, 0] * 1e-9, max_dt=0.05)
    out = {
        "pass": "euroc", "frames_run": frames, "state": slam.state, "n_kf": slam.n_kf,
        "keyframe_frames": rec["kf_at"], "imu_init": rec["init"], "loops_closed": slam.loop_closer.n_loops_closed,
        "lost_frames": rec["lost_frames"], "corrections": rec["corrections"], "stats": slam.stats,
        "frames": len(centers), "trajectory_rows": int(rows.shape[0]),
        "landmarks": int(np.asarray(slam.ms.lm_valid).sum()),
        "ate_m": float(ate.ate_rmse(centers[i_est], gt[i_gt, 1:4])),
        "gravity_end": np.asarray(slam.gravity).tolist(), "seconds": time.time() - t0,
    }
    return out, (times, centers, R_wc, gt[i_gt, 1:4])


def euroc_config():
    """The stereo-inertial camera, ORB and IMU settings that the ``euroc``
    pass writes into its settings YAML (the runner builds its own
    configuration from the file, with the capacity and tracking defaults)."""
    cam = CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX)
    return SLAMConfig(sensor=SensorType.IMU_STEREO, camera=cam, orb=ORBConfig(n_features=1200, cell_size=32),
                      imu=IMUConfig(frequency=IMU_RATE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pass", dest="kind", choices=("rgbd", "fisheye", "fsi", "si", "mono", "mi", "euroc"),
                    required=True)
    ap.add_argument("--frames", type=int, default=N_FRAMES, help="frames of the pass (its first ones)")
    ap.add_argument("--out", default=None, help="npz for the per-frame trajectory")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.kind == "si":
        import jax_si_ref

        jax_si_ref.N_FRAMES = args.frames
        sys.argv = [sys.argv[0]] + (["--out", args.out] if args.out else [])
        return jax_si_ref.main()
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    first_chance_reads()
    assert len(jax.devices()) == 1, "run on one JAX device"
    if args.kind in ("mono", "mi"):
        import jax_mono_ref

        jax_mono_ref.N_FRAMES = args.frames
        scales = []
        solve = inertial.initialize_imu

        def scale_logged(*a, **k):
            res = solve(*a, **k)
            if k.get("estimate_scale"):
                scales.append(float(res[2]))
            return res
        inertial.initialize_imu = scale_logged
        out, (times, centers, R_wc, gt) = jax_mono_ref.run(args.kind)
        inertial.initialize_imu = solve
        out["frames_run"] = args.frames
        if args.kind == "mi":
            out["imu_scales"] = scales
    elif args.kind == "euroc":
        out, (times, centers, R_wc, gt) = run_euroc(args.frames)
    else:
        out, (times, centers, R_wc, gt) = run(args.kind, args.frames)
        out["frames_run"] = args.frames
    print(json.dumps(out))
    if args.out:
        np.savez(args.out, times=times, centers=centers, R_wc=R_wc, gt=gt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
